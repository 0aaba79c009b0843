"""NFA bytecode model for sregex-tpu.

Mirrors the reference instruction/program model
(reference src/sregex/sre_vm_bytecode.{h,c}): 9 opcodes, x/y
branch targets (as integer indices here instead of pointers), a ``tag``
field for O(1) visited-set dedup at run time, and the program-level
metadata (nullable, leading bytes, ovector sizing, multi-regex ncaps).
The dump format matches sre_dump_instruction byte-for-byte: it is part
of the CLI conformance contract.
"""

from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
)


class Instruction:
    """One VM instruction (sre_vm_bytecode.h:45-61)."""

    __slots__ = ("opcode", "x", "y", "tag", "ch", "ranges", "group",
                 "assertion", "regex_id")

    def __init__(self):
        self.opcode = 0
        self.x = 0          # branch target (index into program)
        self.y = 0
        self.tag = 0
        self.ch = 0
        self.ranges = None  # list of (from, to) pairs
        self.group = 0
        self.assertion = 0
        self.regex_id = 0


class Program:
    """Compiled NFA program (sre_vm_bytecode.h:72-87).

    ``ovecsize`` counts sre_int_t slots (2*(ncaps_i+1) summed over
    regexes), not bytes.
    """

    __slots__ = ("insts", "tag", "nullable", "leading_bytes",
                 "leading_byte", "ovecsize", "nregexes", "multi_ncaps",
                 "lookahead_asserts", "uniq_threads", "dup_threads")

    def __init__(self):
        self.insts = []
        self.tag = 0
        self.nullable = 0
        self.leading_bytes = None   # list of instruction indices or None
        self.leading_byte = -1
        self.ovecsize = 0
        self.nregexes = 1
        self.multi_ncaps = [0]
        self.lookahead_asserts = 0
        self.uniq_threads = 0
        self.dup_threads = 0

    def __len__(self):
        return len(self.insts)


_ASSERT_DUMP = {
    SRE_REGEX_ASSERT_BIG_A: "\\A",
    SRE_REGEX_ASSERT_CARET: "^",
    SRE_REGEX_ASSERT_SMALL_Z: "\\z",
    SRE_REGEX_ASSERT_BIG_B: "\\B",
    SRE_REGEX_ASSERT_SMALL_B: "\\b",
    SRE_REGEX_ASSERT_DOLLAR: "$",
}


def dump_instruction(idx, pc):
    """Disassemble one instruction (sre_dump_instruction,
    sre_vm_bytecode.c:27-128)."""
    op = pc.opcode
    if op == OP_SPLIT:
        return "%2d. split %d, %d" % (idx, pc.x, pc.y)
    if op == OP_JMP:
        return "%2d. jmp %d" % (idx, pc.x)
    if op == OP_CHAR:
        return "%2d. char %d" % (idx, pc.ch)
    if op == OP_IN or op == OP_NOTIN:
        name = "in" if op == OP_IN else "notin"
        parts = ["%2d. %s" % (idx, name)]
        for i, (f, t) in enumerate(pc.ranges):
            parts.append("%s %d-%d" % ("," if i > 0 else "", f, t))
        return "".join(parts)
    if op == OP_ANY:
        return "%2d. any" % idx
    if op == OP_MATCH:
        return "%2d. match %d" % (idx, pc.regex_id)
    if op == OP_SAVE:
        return "%2d. save %d" % (idx, pc.group)
    if op == OP_ASSERT:
        return "%2d. assert %s" % (idx, _ASSERT_DUMP.get(pc.assertion, "?"))
    return "%2d. unknown" % idx


def dump_program(prog):
    """Full program disassembly (sre_program_dump), one line per
    instruction, newline-terminated."""
    return "".join(dump_instruction(i, pc) + "\n"
                   for i, pc in enumerate(prog.insts))
