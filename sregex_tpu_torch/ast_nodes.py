"""Regex AST for sregex-tpu.

Node types and the dump format are behaviorally equivalent to the
reference AST (reference src/sregex/sre_regex.{h,c}): 13 node
types (sre_regex.h:18-32), char classes as ordered (from,to) byte-range
lists (sre_regex.h:56-62), and the S-expression dumper
(sre_regex.c:33-167) whose exact output is part of the CLI contract.
"""

from .consts import (
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
)

# Node type tags (sre_regex.h:18-32)
NIL = 0
ALT = 1
CAT = 2
LIT = 3
DOT = 4
PAREN = 5
QUEST = 6
STAR = 7
PLUS = 8
CLASS = 9
NCLASS = 10
ASSERT = 11
TOPLEVEL = 12


class Node:
    """One AST node. ``left``/``right`` children plus a payload union
    (sre_regex.h:73-90): ch / ranges / group / assertion / greedy /
    regex_id; top-level wrapper nodes also carry nregexes+multi_ncaps."""

    __slots__ = ("type", "left", "right", "ch", "ranges", "group",
                 "assertion", "greedy", "regex_id", "nregexes",
                 "multi_ncaps")

    def __init__(self, type_, left=None, right=None):
        self.type = type_
        self.left = left
        self.right = right
        self.ch = 0
        self.ranges = None   # list of [from, to] byte pairs, ordered
        self.group = 0
        self.assertion = 0
        self.greedy = 0
        self.regex_id = 0
        self.nregexes = 0
        self.multi_ncaps = None


_ASSERT_NAMES = {
    SRE_REGEX_ASSERT_BIG_A: "\\A",
    SRE_REGEX_ASSERT_CARET: "^",
    SRE_REGEX_ASSERT_DOLLAR: "$",
    SRE_REGEX_ASSERT_SMALL_Z: "\\z",
    SRE_REGEX_ASSERT_BIG_B: "\\B",
    SRE_REGEX_ASSERT_SMALL_B: "\\b",
}


def dump(node, out):
    """Append the reference dump text for ``node`` to list ``out``.

    Format mirrors sre_regex_dump (sre_regex.c:33-167) byte-for-byte.
    Iterative worklist (the reference recurses; regexes can nest deeply).
    """
    work = [node]
    while work:
        n = work.pop()
        if isinstance(n, str):
            out.append(n)
            continue
        t = n.type
        if t == ALT:
            out.append("Alt(")
            work += [")", n.right, ", ", n.left]
        elif t == CAT:
            out.append("Cat(")
            work += [")", n.right, ", ", n.left]
        elif t == LIT:
            out.append("Lit(%d)" % n.ch)
        elif t == DOT:
            out.append("Dot")
        elif t == PAREN:
            out.append("Paren(%d, " % n.group)
            work += [")", n.left]
        elif t == STAR:
            out.append("Star(" if n.greedy else "NgStar(")
            work += [")", n.left]
        elif t == PLUS:
            out.append("Plus(" if n.greedy else "NgPlus(")
            work += [")", n.left]
        elif t == QUEST:
            out.append("Quest(" if n.greedy else "NgQuest(")
            work += [")", n.left]
        elif t == NIL:
            out.append("Nil")
        elif t == CLASS or t == NCLASS:
            out.append("CLASS(" if t == CLASS else "NCLASS(")
            for f, to in (n.ranges or []):
                out.append("[%d, %d]" % (f, to))
            out.append(")")
        elif t == ASSERT:
            out.append("ASSERT(%s)" % _ASSERT_NAMES.get(n.assertion, "???"))
        elif t == TOPLEVEL:
            out.append("TOPLEVEL(%d, " % n.regex_id)
            work += [")", n.left]
        else:
            out.append("???")


def dump_str(node):
    out = []
    dump(node, out)
    return "".join(out)


def turn_char_class_caseless(ranges):
    """Case-insensitive class expansion (sre_regex.c:170-214).

    For every original range overlapping A-Z, insert the +32-shifted
    overlap right after it; likewise a-z gets the -32-shifted overlap.
    The from/to of each range are snapshot before insertion and the
    inserted ranges themselves are skipped, exactly as the reference's
    in-place linked-list walk does.  Mutates and returns ``ranges``.
    """
    if not ranges:
        return ranges
    i = 0
    while i < len(ranges):
        from_, to = ranges[i]
        if to >= 65 and from_ <= 90:        # overlap with A-Z
            i += 1
            ranges.insert(i, [max(from_, 65) + 32, min(to, 90) + 32])
        if to >= 97 and from_ <= 122:       # overlap with a-z
            i += 1
            ranges.insert(i, [max(from_, 97) - 32, min(to, 122) - 32])
        i += 1
    return ranges


def max_match_len(node):
    """Maximum number of bytes one match of ``node`` can span, or
    None when unbounded (STAR/PLUS — counted repetitions are already
    desugared into CAT/QUEST chains at parse time, so a{n,m} is
    bounded and a{n,} is not).  Pass the INNER pattern (the wrapped
    root's .right: the TOPLEVEL chain) — the ``.*?`` scan wrapper is
    the unanchored-search prefix, not part of the match.  Iterative
    (desugared reps nest thousands of CATs deep)."""
    memo = {}
    stack = [(node, False)]
    while stack:
        nd, ready = stack.pop()
        if nd is None:
            continue
        key = id(nd)
        if key in memo and not ready:
            continue
        t = nd.type
        if t in (LIT, DOT, CLASS, NCLASS):
            memo[key] = 1
            continue
        if t in (NIL, ASSERT):
            memo[key] = 0
            continue
        if t in (STAR, PLUS):
            memo[key] = None
            continue
        if not ready:
            stack.append((nd, True))
            stack.append((nd.left, False))
            if t in (CAT, ALT):
                stack.append((nd.right, False))
            continue
        left = memo.get(id(nd.left), 0)
        if t == CAT:
            right = memo.get(id(nd.right), 0)
            memo[key] = None if (left is None or right is None) \
                else left + right
        elif t == ALT:
            right = memo.get(id(nd.right), 0)
            memo[key] = None if (left is None or right is None) \
                else max(left, right)
        else:  # PAREN, TOPLEVEL, QUEST wrap their child in .left
            memo[key] = left
    return memo[id(node)] if node is not None else 0
