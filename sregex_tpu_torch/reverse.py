"""Regex AST reversal, for locating match STARTS by scanning the
corpus backwards.

A forward match of `re` over data[s:e) is exactly a match of
reverse(re) over reversed(data)[n-e : n-s).  The leftmost-first winner
of the Pike VM starts at the minimal start of any completed match
(the non-greedy `.*?` prefix gives earlier starts strictly higher
priority), so:

    s* = n - (last boundary at which reverse(re) matches on
              reversed(data))

which the device DFA scan computes at full speed.  Exact captures are
then resolved by running the Pike engine from s* with the proper
seen_word/seen_newline context carry — only the match region is
simulated.

Reversal rules: concatenation flips; alternation/quantifiers recurse;
context assertions swap sides (^ <-> $, \\A <-> \\z); \\b/\\B are
symmetric; literals/classes unchanged.
"""

from .ast_nodes import (Node, NIL, ALT, CAT, LIT, DOT, PAREN, QUEST,
                        STAR, PLUS, CLASS, NCLASS, ASSERT, TOPLEVEL)
from .consts import (
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET,
    SRE_REGEX_ASSERT_DOLLAR, SRE_REGEX_ASSERT_SMALL_Z,
    SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
)

_ASSERT_SWAP = {
    SRE_REGEX_ASSERT_BIG_A: SRE_REGEX_ASSERT_SMALL_Z,
    SRE_REGEX_ASSERT_SMALL_Z: SRE_REGEX_ASSERT_BIG_A,
    SRE_REGEX_ASSERT_CARET: SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_DOLLAR: SRE_REGEX_ASSERT_CARET,
    SRE_REGEX_ASSERT_BIG_B: SRE_REGEX_ASSERT_BIG_B,
    SRE_REGEX_ASSERT_SMALL_B: SRE_REGEX_ASSERT_SMALL_B,
}


def _rev(node):
    t = node.type
    if t in (NIL, LIT, DOT, CLASS, NCLASS):
        return node
    if t == ASSERT:
        n = Node(ASSERT)
        n.assertion = _ASSERT_SWAP[node.assertion]
        return n
    if t == CAT:
        return Node(CAT, _rev(node.right), _rev(node.left))
    if t == ALT:
        return Node(ALT, _rev(node.left), _rev(node.right))
    if t in (QUEST, STAR, PLUS):
        n = Node(t, _rev(node.left))
        n.greedy = node.greedy
        return n
    if t == PAREN:
        n = Node(PAREN, _rev(node.left))
        n.group = node.group
        return n
    if t == TOPLEVEL:
        n = Node(TOPLEVEL, _rev(node.left))
        n.regex_id = node.regex_id
        return n
    raise ValueError("unknown node type %r" % t)


def reverse_wrapped_ast(root):
    """Reverse a parse()/parse_multi() result (the wrapped
    Cat(NgStar(Dot), body) form), preserving the unanchored-scan
    wrapper and the multi-regex metadata."""
    import sys
    assert root.type == CAT
    star, body = root.left, root.right
    old = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(max(old, 200000))
        out = Node(CAT, star, _rev(body))
    finally:
        sys.setrecursionlimit(old)
    out.nregexes = root.nregexes
    out.multi_ncaps = root.multi_ncaps
    return out
