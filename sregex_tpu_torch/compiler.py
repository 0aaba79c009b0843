"""AST -> NFA bytecode compiler for sregex-tpu.

Behaviorally equivalent to the reference compiler
(reference src/sregex/sre_regex_compiler.c): exact two-pass
instruction-count + single-buffer emission (:244-285, :288-482), the
same codegen patterns (ALT -> split/jmp, STAR -> split;body;jmp,
PLUS -> body;split, QUEST -> split, non-greedy = swapped split arms,
PAREN -> save 2g/2g+1, TOPLEVEL -> body;match id), ovector sizing
(:82-86), and the nullable/leading-bytes post-pass (:123-241) with the
".*?" boilerplate-dot skip at instruction 1 (:161-164).
"""

import sys

from . import ast_nodes as A
from .ast_nodes import (
    NIL, ALT, CAT, LIT, DOT, PAREN, QUEST, STAR, PLUS, CLASS, NCLASS,
    ASSERT, TOPLEVEL,
)
from .bytecode import Instruction, Program
from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT, SRE_REGEX_ASSERT_LOOKAHEAD,
)


def _program_len(r):
    """Exact instruction count per node (sre_program_len,
    sre_regex_compiler.c:244-285).  Iterative: desugared counted
    repetitions produce deep CAT chains."""
    n = 0
    stack = [r]
    while stack:
        node = stack.pop()
        t = node.type
        if t == ALT:
            n += 2
            stack.append(node.left)
            stack.append(node.right)
        elif t == CAT:
            stack.append(node.left)
            stack.append(node.right)
        elif t in (LIT, DOT, CLASS, NCLASS, ASSERT):
            n += 1
        elif t == PAREN:
            n += 2
            stack.append(node.left)
        elif t in (QUEST, PLUS):
            n += 1
            stack.append(node.left)
        elif t == STAR:
            n += 2
            stack.append(node.left)
        elif t == TOPLEVEL:
            n += 1
            stack.append(node.left)
        # NIL: 0
    return n


def _emit(insts, pc, r):
    """Emit bytecode for node ``r`` starting at index ``pc``; returns
    the next free index (sre_regex_emit_bytecode,
    sre_regex_compiler.c:288-482)."""
    t = r.type

    if t == ALT:
        p1 = pc
        insts[p1].opcode = OP_SPLIT
        pc += 1
        insts[p1].x = pc
        pc = _emit(insts, pc, r.left)
        p2 = pc
        insts[p2].opcode = OP_JMP
        pc += 1
        insts[p1].y = pc
        pc = _emit(insts, pc, r.right)
        insts[p2].x = pc
        return pc

    if t == CAT:
        pc = _emit(insts, pc, r.left)
        return _emit(insts, pc, r.right)

    if t == LIT:
        insts[pc].opcode = OP_CHAR
        insts[pc].ch = r.ch
        return pc + 1

    if t == CLASS or t == NCLASS:
        insts[pc].opcode = OP_IN if t == CLASS else OP_NOTIN
        insts[pc].ranges = [(f, to) for f, to in r.ranges]
        return pc + 1

    if t == DOT:
        insts[pc].opcode = OP_ANY
        return pc + 1

    if t == PAREN:
        insts[pc].opcode = OP_SAVE
        insts[pc].group = 2 * r.group
        pc = _emit(insts, pc + 1, r.left)
        insts[pc].opcode = OP_SAVE
        insts[pc].group = 2 * r.group + 1
        return pc + 1

    if t == QUEST:
        p1 = pc
        insts[p1].opcode = OP_SPLIT
        pc += 1
        insts[p1].x = pc
        pc = _emit(insts, pc, r.left)
        insts[p1].y = pc
        if not r.greedy:
            insts[p1].x, insts[p1].y = insts[p1].y, insts[p1].x
        return pc

    if t == STAR:
        p1 = pc
        insts[p1].opcode = OP_SPLIT
        pc += 1
        insts[p1].x = pc
        pc = _emit(insts, pc, r.left)
        insts[pc].opcode = OP_JMP
        insts[pc].x = p1
        pc += 1
        insts[p1].y = pc
        if not r.greedy:
            insts[p1].x, insts[p1].y = insts[p1].y, insts[p1].x
        return pc

    if t == PLUS:
        p1 = pc
        pc = _emit(insts, pc, r.left)
        p2 = pc
        insts[p2].opcode = OP_SPLIT
        insts[p2].x = p1
        pc += 1
        insts[p2].y = pc
        if not r.greedy:
            insts[p2].x, insts[p2].y = insts[p2].y, insts[p2].x
        return pc

    if t == ASSERT:
        insts[pc].opcode = OP_ASSERT
        insts[pc].assertion = r.assertion
        return pc + 1

    if t == TOPLEVEL:
        pc = _emit(insts, pc, r.left)
        insts[pc].opcode = OP_MATCH
        insts[pc].regex_id = r.regex_id
        return pc + 1

    # NIL
    return pc


def _get_leading_bytes(prog):
    """Leading-bytes extraction + nullable detection
    (sre_program_get_leading_bytes, sre_regex_compiler.c:123-241).

    Walks the epsilon closure from instruction 0, skipping the
    boilerplate ".*?" dot at index 1; collects the first consuming
    instructions.  A reachable MATCH sets nullable; a reachable ANY
    declines (prefilter impossible).  Iterative DFS preserving the
    reference's x-before-y order and its early-stop on the first
    reachable MATCH.
    """
    insts = prog.insts
    n = len(insts)
    tag = prog.tag + 1
    prog.tag = tag
    res = []
    res_chars = set()
    res_idx = set()

    # Explicit stack; entries are instruction indices.  Reference
    # recursion order: SPLIT -> x then y; JMP -> x; SAVE/ASSERT ->
    # fall-through; MATCH -> DONE (stop entire walk); ANY -> DECLINED.
    stack = [0]
    declined = False
    done = False
    while stack and not done and not declined:
        pc = stack.pop()
        if pc >= n:
            continue
        ins = insts[pc]
        if ins.tag == tag:
            continue
        if pc == 1:
            # skip the dot (.) in the initial boilerplate ".*?"
            continue
        ins.tag = tag
        op = ins.opcode
        if op == OP_SPLIT:
            stack.append(ins.y)
            stack.append(ins.x)
        elif op == OP_JMP:
            stack.append(ins.x)
        elif op == OP_SAVE or op == OP_ASSERT:
            stack.append(pc + 1)
        elif op == OP_MATCH:
            prog.nullable = 1
            done = True
        elif op == OP_ANY:
            declined = True
        else:
            # CHAR, IN, NOTIN: collect (dedup identical CHARs only,
            # like the reference)
            if op == OP_CHAR:
                if ins.ch in res_chars:
                    continue
                res_chars.add(ins.ch)
            if pc not in res_idx:
                res_idx.add(pc)
                res.append(pc)

    if declined or prog.nullable:
        return None
    return res or None


def compile_regex(re_ast):
    """Compile a parsed AST into a Program (sre_regex_compile,
    sre_regex_compiler.c:31-120)."""
    n = _program_len(re_ast)
    prog = Program()
    prog.nregexes = re_ast.nregexes
    prog.multi_ncaps = list(re_ast.multi_ncaps)
    prog.insts = [Instruction() for _ in range(n)]

    old_limit = sys.getrecursionlimit()
    try:
        # _emit recursion depth tracks AST depth (deep CAT chains from
        # counted-repetition unrolling); py3.12 heap frames make this safe
        sys.setrecursionlimit(max(old_limit, n * 2 + 10000))
        end = _emit(prog.insts, 0, re_ast)
    finally:
        sys.setrecursionlimit(old_limit)
    if end != n:
        raise RuntimeError("compiler buffer error: %d != %d" % (end, n))

    prog.ovecsize = 0
    for i in range(prog.nregexes):
        prog.ovecsize += prog.multi_ncaps[i] + 1
    prog.ovecsize *= 2

    prog.lookahead_asserts = 0
    for ins in prog.insts:
        if ins.opcode == OP_ASSERT:
            prog.lookahead_asserts |= (ins.assertion
                                       & SRE_REGEX_ASSERT_LOOKAHEAD)

    prog.leading_bytes = _get_leading_bytes(prog)
    prog.leading_byte = -1
    if prog.leading_bytes and len(prog.leading_bytes) == 1:
        ins = prog.insts[prog.leading_bytes[0]]
        if ins.opcode == OP_CHAR:
            prog.leading_byte = ins.ch

    return prog
