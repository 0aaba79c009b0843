"""Regex text -> AST parser for sregex-tpu.

Feature- and semantics-equivalent to the reference's bison parser +
hand-written lexer (reference src/sregex/sre_yyparser.y), but
written as a recursive-descent parser over a Python token stream.

Covered surface (sre_yyparser.y:350-1795 lexer, :103-345 grammar):
  - metas | * + ? ( ) : . ^ $, bracket classes [..] / [^..]
  - escapes \\t \\n \\r \\f \\a \\e (\\b backspace in class), \\cK,
    octal (\\0dd, \\o{..}), hex (\\xhh, \\x{..})
  - class escapes \\d \\D \\w \\W \\s \\S \\h \\H \\v \\V \\N \\C
  - assertions \\A \\z \\b \\B ^ $
  - greedy/non-greedy * + ? and counted {n}, {n,}, {n,m} (+'?')
    with the <500 bound and {0,1}/{0,}/{1,} canonicalization
    (sre_yyparser.y:1752-1779)
  - capture groups (..), non-capture (?:..)
  - CASELESS and NEWLINE flags applied at parse time
  - multi-regex assembly with continued group numbering
    (sre_yyparser.y:1871-1986)
"""

from .ast_nodes import (
    Node, NIL, ALT, CAT, LIT, DOT, PAREN, QUEST, STAR, PLUS, CLASS,
    NCLASS, ASSERT, TOPLEVEL, turn_char_class_caseless,
)
from .consts import (
    SRE_REGEX_CASELESS, SRE_REGEX_NEWLINE,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
)


class ParseError(Exception):
    """Syntax error; ``offset`` is the byte offset of the offending
    token's start (reference yyerror records locp->pos,
    sre_yyparser.y:1798-1803)."""

    def __init__(self, offset, regex_id=-1):
        super().__init__("syntax error at pos %d" % offset)
        self.offset = offset
        self.regex_id = regex_id


# Token kinds
T_CHAR = "char"       # literal byte; value = int
T_EOF = "eof"
T_BAD = "bad"
T_CQUANT = "cquant"   # value = (from, to); to == -1 means unbounded
T_CLASS = "class"     # value = Node (CLASS/NCLASS/DOT)
T_ASSERT = "assert"   # value = Node (ASSERT)
T_META = "meta"       # value = one of "|*+?():.^$"


# Class-escape range tables (sre_yyparser.y:361-384).  All ordered.
_ESC_D = [(48, 57)]
_ESC_CAP_D = [(0, 47), (58, 255)]
_ESC_W = [(65, 90), (97, 122), (48, 57), (95, 95)]
_ESC_CAP_W = [(0, 47), (58, 64), (91, 94), (96, 96), (123, 255)]
_ESC_S = [(32, 32), (12, 12), (10, 10), (13, 13), (9, 9)]
_ESC_CAP_S = [(0, 8), (11, 11), (14, 31), (33, 255)]
_ESC_H = [(9, 9), (32, 32), (0xA0, 0xA0)]
_ESC_CAP_H = [(0x00, 0x08), (0x0A, 0x1F), (0x21, 0x9F), (0xA1, 0xFF)]
_ESC_V = [(0x0A, 0x0A), (0x0B, 0x0B), (0x0C, 0x0C), (0x0D, 0x0D),
          (0x85, 0x85)]
_ESC_CAP_V = [(0x00, 0x09), (0x0E, 0x84), (0x86, 0xFF)]

# In-class table selection (sre_yyparser.y:1264-1612): lower-case class
# escapes append their positive ranges; upper-case append the
# precomputed complement ranges.
_CLASS_ESC_RANGES = {
    ord('d'): _ESC_D, ord('D'): _ESC_CAP_D,
    ord('w'): _ESC_W, ord('W'): _ESC_CAP_W,
    ord('s'): _ESC_S, ord('S'): _ESC_CAP_S,
    ord('v'): _ESC_V, ord('V'): _ESC_CAP_V,
    ord('h'): _ESC_H, ord('H'): _ESC_CAP_H,
}

_METAS = frozenset(b"|*+?():.^$")
# Printable chars that escape to themselves outside a class
# (sre_yyparser.y:412 strchr set, plus the later '"', "'", '#' cases)
_ESC_LITERALS = frozenset(b"'\" iM%@!,_-|*+?():.^$&\\/[]{}#")
# Same, inside a bracket class (sre_yyparser.y:1341 strchr set)
_CLASS_ESC_LITERALS = frozenset(b"'\" iMzC%@!,_-|*+?():.^$&\\/[]{}")
_SIMPLE_ESCAPES = {
    ord('t'): 9, ord('n'): 10, ord('r'): 13, ord('f'): 12,
    ord('a'): 7, ord('e'): 27,
}


def _is_print(c):
    return 32 <= c <= 126


def _make_class(type_, ranges):
    n = Node(type_)
    n.ranges = [list(r) for r in ranges]
    return n


def _noteol(_=None):
    """[^\\n] node (sre_regex_create_noteol, sre_yyparser.y:1988-2009)."""
    return _make_class(NCLASS, [(10, 10)])


def _assert_node(bit):
    n = Node(ASSERT)
    n.assertion = bit
    return n


class _Lexer:
    """Tokenizer over a byte string; mirrors yylex
    (sre_yyparser.y:350-1795)."""

    def __init__(self, src, flags):
        self.src = src
        self.i = 0
        self.flags = flags

    def _eof(self):
        return self.i >= len(self.src)

    def _read(self):
        c = self.src[self.i]
        self.i += 1
        return c

    def _peek(self):
        return self.src[self.i] if self.i < len(self.src) else -1

    def next(self):
        """Return (kind, value, pos)."""
        pos = self.i
        if self._eof():
            return (T_EOF, None, pos)

        c = self._read()
        if c in _METAS:
            return (T_META, chr(c), pos)

        if c == 0x5C:  # backslash
            return self._lex_escape(pos)

        if c == 0x5B:  # '['
            return self._lex_class(pos)

        if c == 0x7B:  # '{'
            return self._lex_cquant(pos)

        return (T_CHAR, c, pos)

    # -- escapes outside a bracket class ------------------------------

    def _lex_escape(self, pos):
        if self._eof():
            return (T_BAD, None, pos)
        c = self._read()

        # non-printable chars escape to themselves (sre_yyparser.y:406-410)
        if not _is_print(c):
            return (T_CHAR, c, pos)

        if c in _ESC_LITERALS:
            return (T_CHAR, c, pos)

        if 0x30 <= c <= 0x37:  # leading octal digit
            return self._lex_octal_toplevel(c, pos)

        if c == ord('c'):
            if self._eof():
                return (T_BAD, None, pos)
            c = self._read()
            if ord('a') <= c <= ord('z'):
                c -= 32
            return (T_CHAR, (c ^ 64) & 0xFF, pos)

        if c == ord('o'):
            ok, num = self._lex_brace_octal()
            return (T_CHAR, num & 0xFF, pos) if ok else (T_BAD, None, pos)

        if c == ord('x'):
            ok, num = self._lex_hex()
            return (T_CHAR, num & 0xFF, pos) if ok else (T_BAD, None, pos)

        if c == ord('B'):
            return (T_ASSERT, _assert_node(SRE_REGEX_ASSERT_BIG_B), pos)
        if c == ord('b'):
            return (T_ASSERT, _assert_node(SRE_REGEX_ASSERT_SMALL_B), pos)
        if c == ord('z'):
            return (T_ASSERT, _assert_node(SRE_REGEX_ASSERT_SMALL_Z), pos)
        if c == ord('A'):
            return (T_ASSERT, _assert_node(SRE_REGEX_ASSERT_BIG_A), pos)

        if c == ord('d'):
            return (T_CLASS, _make_class(CLASS, _ESC_D), pos)
        if c == ord('D'):
            return (T_CLASS, _make_class(NCLASS, _ESC_D), pos)
        if c == ord('w'):
            return (T_CLASS, _make_class(CLASS, _ESC_W), pos)
        if c == ord('W'):
            # \W outside a class is NCLASS over the \w ranges
            # (sre_yyparser.y:733-771)
            return (T_CLASS, _make_class(NCLASS, _ESC_W), pos)
        if c == ord('s'):
            return (T_CLASS, _make_class(CLASS, _ESC_S), pos)
        if c == ord('S'):
            return (T_CLASS, _make_class(NCLASS, _ESC_S), pos)
        if c == ord('h'):
            return (T_CLASS, _make_class(CLASS, _ESC_H), pos)
        if c == ord('H'):
            return (T_CLASS, _make_class(NCLASS, _ESC_H), pos)
        if c == ord('v'):
            return (T_CLASS, _make_class(CLASS, _ESC_V), pos)
        if c == ord('V'):
            return (T_CLASS, _make_class(NCLASS, _ESC_V), pos)
        if c == ord('N'):
            return (T_CLASS, _noteol(), pos)
        if c == ord('C'):
            # \C is "." (any octet); [^\n] under NEWLINE
            # (sre_yyparser.y:864-881)
            if self.flags & SRE_REGEX_NEWLINE:
                return (T_CLASS, _noteol(), pos)
            return (T_CLASS, Node(DOT), pos)

        if c in _SIMPLE_ESCAPES:
            return (T_CHAR, _SIMPLE_ESCAPES[c], pos)

        return (T_BAD, None, pos)

    def _lex_octal_toplevel(self, c, pos):
        """\\ddd outside a class (sre_yyparser.y:419-453).  A 1-digit
        nonzero escape (e.g. \\1) is rejected: backreferences are
        unsupported."""
        num = c - 0x30
        i = 1
        while True:
            c = self._peek()
            if c < 0x30 or c > 0x37:
                i += 1
                if i != 3 and num != 0:
                    return (T_BAD, None, pos)
                return (T_CHAR, num & 0xFF, pos)
            num = (c - 0x30) + (num << 3)
            self.i += 1
            i += 1
            if i == 3:
                if num > 255:
                    return (T_BAD, None, pos)
                return (T_CHAR, num, pos)

    def _lex_brace_octal(self):
        """\\o{...} (sre_yyparser.y:474-531).  Returns (ok, num).
        Quirk preserved: a non-octal, non-'}' char before the 3rd digit
        terminates the number and rewinds one char."""
        if self._eof() or self._read() != ord('{'):
            return (False, 0)
        if self._eof():
            return (False, 0)
        c = self._read()
        num = 0
        i = 0
        while True:
            if 0x30 <= c <= 0x37:
                num = (c - 0x30) + (num << 3)
            elif c == ord('}'):
                return (True, num)
            else:
                self.i -= 1
                break
            i += 1
            if i == 3:
                if self._eof() or self._read() != ord('}'):
                    return (False, 0)
                if num > 255:
                    return (False, 0)
                break
            if self._eof():
                return (False, 0)
            c = self._read()
        return (True, num)

    def _lex_hex(self):
        """\\xhh / \\x{hh} (sre_yyparser.y:533-593).  Returns (ok, num)."""
        if self._eof():
            return (True, 0)  # bare \x at end: 0 digits -> NUL
        c = self._read()
        curly = False
        if c == ord('{'):
            curly = True
            if self._eof():
                return (False, 0)
            c = self._read()
        num = 0
        i = 0
        while True:
            d = _hex_val(c)
            if d >= 0:
                num = d + (num << 4)
            elif curly:
                if c != ord('}'):
                    return (False, 0)
                return (True, num)
            else:
                self.i -= 1
                break
            i += 1
            if i == 2:
                if curly:
                    if self._eof() or self._read() != ord('}'):
                        return (False, 0)
                break
            if self._eof():
                if curly:
                    return (False, 0)
                break
            c = self._read()
        return (True, num)

    # -- bracket classes ----------------------------------------------

    def _lex_class(self, pos):
        """[...] / [^...] (sre_yyparser.y:1069-1691)."""
        negated = False
        if self._peek() == ord('^'):
            negated = True
            self.i += 1

        node = Node(NCLASS if negated else CLASS)
        ranges = []          # list of [from, to]
        seen_dash = False
        no_dash = False
        n = 0

        def append(c):
            ranges.append([c, c])

        while True:
            n += 1
            if self._eof():
                return (T_BAD, None, pos)
            c = self._read()

            if c == ord(']') and n > 1:
                if seen_dash:
                    ranges.append([ord('-'), ord('-')])
                node.ranges = ranges
                # NB: matching the reference, the NEWLINE \n-append
                # block after this loop is unreachable (the ']' case
                # returns directly, sre_yyparser.y:1103-1131).
                return (T_CLASS, node, pos)

            is_class_escape = False
            if c == 0x5C:  # backslash inside class
                if self._eof():
                    return (T_BAD, None, pos)
                c = self._read()

                if 0x30 <= c <= 0x37:
                    # in-class octal: up to 3 digits, no 1-digit
                    # rejection (sre_yyparser.y:1135-1168)
                    num = c - 0x30
                    i = 1
                    bad = False
                    while True:
                        c2 = self._peek()
                        if c2 < 0x30 or c2 > 0x37:
                            c = num & 0xFF
                            break
                        num = (c2 - 0x30) + (num << 3)
                        self.i += 1
                        i += 1
                        if i == 3:
                            if num > 255:
                                bad = True
                            c = num & 0xFF
                            break
                    if bad:
                        return (T_BAD, None, pos)
                elif c == ord('c'):
                    if self._eof():
                        return (T_BAD, None, pos)
                    c = self._read()
                    if ord('a') <= c <= ord('z'):
                        c -= 32
                    c = (c ^ 64) & 0xFF
                elif c == ord('o'):
                    ok, num = self._lex_class_brace_octal()
                    if not ok:
                        return (T_BAD, None, pos)
                    c = num & 0xFF
                elif c == ord('x'):
                    ok, num = self._lex_hex()
                    if not ok:
                        return (T_BAD, None, pos)
                    c = num & 0xFF
                elif c in _SIMPLE_ESCAPES:
                    c = _SIMPLE_ESCAPES[c]
                elif c == ord('b'):
                    c = 8  # backspace, in class only
                elif c == ord('#') or c == ord('"') or c == ord("'"):
                    pass
                elif not _is_print(c):
                    pass
                elif c in _CLASS_ESC_LITERALS:
                    pass
                elif c in _CLASS_ESC_RANGES:
                    # class escape inside brackets: append its ranges;
                    # a pending dash first becomes a literal '-'
                    # (sre_yyparser.y:1356-1370)
                    if seen_dash:
                        ranges.append([ord('-'), ord('-')])
                        seen_dash = False
                    for f, t in _CLASS_ESC_RANGES[c]:
                        ranges.append([f, t])
                    no_dash = True
                    is_class_escape = True
                else:
                    return (T_BAD, None, pos)

                if is_class_escape:
                    continue
                # fall through to process_char with literal byte c

            elif c == ord('-'):
                if not seen_dash and ranges and not no_dash:
                    seen_dash = True
                    continue
                # else: literal '-' via process_char

            # process_char (sre_yyparser.y:1629-1666)
            if seen_dash:
                ranges[-1][1] = c
                if ranges[-1][1] < ranges[-1][0]:
                    return (T_BAD, None, pos)
                seen_dash = False
                no_dash = True
                continue
            no_dash = False
            append(c)

    def _lex_class_brace_octal(self):
        """\\o{...} inside a class (sre_yyparser.y:1189-1236): unlike
        the top-level version, a non-octal char inside braces is BAD."""
        if self._eof() or self._read() != ord('{'):
            return (False, 0)
        if self._eof():
            return (False, 0)
        c = self._read()
        num = 0
        i = 0
        while True:
            if 0x30 <= c <= 0x37:
                num = (c - 0x30) + (num << 3)
            elif c == ord('}'):
                return (True, num)
            else:
                return (False, 0)
            i += 1
            if i == 3:
                if self._eof() or self._read() != ord('}'):
                    return (False, 0)
                if num > 255:
                    return (False, 0)
                return (True, num)
            if self._eof():
                return (False, 0)
            c = self._read()

    # -- counted quantifiers ------------------------------------------

    def _lex_cquant(self, pos):
        """{n}, {n,}, {n,m} (sre_yyparser.y:1693-1788).  A '{' not
        followed by a well-formed quantifier is a literal '{'."""
        src, i = self.src, self.i

        def digits(j):
            v = 0
            seen = False
            while j < len(src) and 0x30 <= src[j] <= 0x39:
                v = (src[j] - 0x30) + v * 10
                j += 1
                seen = True
            return v, j, seen

        from_, j, seen = digits(i)
        if not seen:
            return (T_CHAR, ord('{'), pos)
        if j < len(src) and src[j] == ord('}'):
            to = from_
            self.i = j + 1
        elif j < len(src) and src[j] == ord(','):
            j += 1
            if j < len(src) and src[j] == ord('}'):
                to = -1
                self.i = j + 1
            else:
                to, j, seen = digits(j)
                if not seen or j >= len(src) or src[j] != ord('}'):
                    return (T_CHAR, ord('{'), pos)
                self.i = j + 1
        else:
            return (T_CHAR, ord('{'), pos)

        if from_ >= 500 or to >= 500:
            return (T_BAD, None, pos)
        if to >= 0 and from_ > to:
            return (T_BAD, None, pos)
        if from_ == 0:
            if to == 1:
                return (T_META, '?', pos)
            if to == -1:
                return (T_META, '*', pos)
        elif from_ == 1 and to == -1:
            return (T_META, '+', pos)
        return (T_CQUANT, (from_, to), pos)


def _hex_val(c):
    if 0x30 <= c <= 0x39:
        return c - 0x30
    if 0x41 <= c <= 0x46:
        return c - 0x41 + 10
    if 0x61 <= c <= 0x66:
        return c - 0x61 + 10
    return -1


def desugar_counted_repetition(subj, from_, to, greedy):
    """a{n,m} unrolling (sre_yyparser.y:2011-2084): a{n,m} ->
    a..a (a?){m-n}; a{n,} -> a..a a*.  Shares ``subj`` across copies
    like the reference does."""
    if from_ == 1 and to == 1:
        return subj

    if from_ == 0:
        concat = Node(NIL)
        i = 0
    else:
        concat = subj
        for i in range(1, from_):
            concat = Node(CAT, concat, subj)
        i = from_

    if from_ == to:
        return concat

    if to == -1:
        star = Node(STAR, subj)
        star.greedy = greedy
        return Node(CAT, concat, star)

    quest = Node(QUEST, subj)
    quest.greedy = greedy
    while i < to:
        concat = Node(CAT, concat, quest)
        i += 1
    return concat


_QUANTS = frozenset("*+?")


class _Parser:
    """Recursive-descent equivalent of the reference grammar
    (sre_yyparser.y:103-345): regex -> alt -> concat -> repeat -> atom."""

    def __init__(self, src, flags, ncaps):
        self.lex = _Lexer(src, flags)
        self.flags = flags
        self.ncaps = ncaps
        self.tok = self.lex.next()

    def error(self):
        raise ParseError(self.tok[2])

    def advance(self):
        self.tok = self.lex.next()

    def parse(self):
        node = self.alt()
        if self.tok[0] != T_EOF:
            self.error()
        return node

    def alt(self):
        node = self.concat()
        while self.tok[0] == T_META and self.tok[1] == '|':
            self.advance()
            node = Node(ALT, node, self.concat())
        return node

    def _atom_startable(self):
        kind, val = self.tok[0], self.tok[1]
        if kind in (T_CHAR, T_CLASS, T_ASSERT):
            return True
        if kind == T_META:
            return val in "(.^$:"
        return False

    def concat(self):
        if not self._atom_startable():
            return Node(NIL)
        node = self.repeat()
        while self._atom_startable():
            node = Node(CAT, node, self.repeat())
        return node

    def repeat(self):
        node = self.atom()
        kind, val = self.tok[0], self.tok[1]
        if kind == T_META and val in _QUANTS:
            self.advance()
            greedy = 1
            if self.tok[0] == T_META and self.tok[1] == '?':
                greedy = 0
                self.advance()
            t = {'*': STAR, '+': PLUS, '?': QUEST}[val]
            q = Node(t, node)
            q.greedy = greedy
            return q
        if kind == T_CQUANT:
            from_, to = val
            self.advance()
            greedy = 1
            if self.tok[0] == T_META and self.tok[1] == '?':
                greedy = 0
                self.advance()
            return desugar_counted_repetition(node, from_, to, greedy)
        return node

    def atom(self):
        kind, val, _pos = self.tok
        if kind == T_META:
            if val == '(':
                self.advance()
                if self.tok[0] == T_META and self.tok[1] == '?':
                    self.advance()
                    if not (self.tok[0] == T_META and self.tok[1] == ':'):
                        self.error()
                    self.advance()
                    node = self.alt()
                    if not (self.tok[0] == T_META and self.tok[1] == ')'):
                        self.error()
                    self.advance()
                    return node
                # capture group: numbered at open-paren time
                # (count rule, sre_yyparser.y:223-226)
                self.ncaps += 1
                group = self.ncaps
                node = self.alt()
                if not (self.tok[0] == T_META and self.tok[1] == ')'):
                    self.error()
                self.advance()
                paren = Node(PAREN, node)
                paren.group = group
                return paren
            if val == '.':
                self.advance()
                if self.flags & SRE_REGEX_NEWLINE:
                    return _noteol()
                return Node(DOT)
            if val == '^':
                self.advance()
                return _assert_node(SRE_REGEX_ASSERT_CARET)
            if val == '$':
                self.advance()
                return _assert_node(SRE_REGEX_ASSERT_DOLLAR)
            if val == ':':
                self.advance()
                lit = Node(LIT)
                lit.ch = ord(':')
                return lit
            self.error()
        if kind == T_CHAR:
            self.advance()
            if (self.flags & SRE_REGEX_CASELESS) and (
                    65 <= val <= 90 or 97 <= val <= 122):
                # caseless literal -> two-singleton class
                # (sre_yyparser.y:243-289)
                other = val + 32 if val <= 90 else val - 32
                return _make_class(CLASS, [(val, val), (other, other)])
            lit = Node(LIT)
            lit.ch = val
            return lit
        if kind == T_ASSERT:
            self.advance()
            return val
        if kind == T_CLASS:
            self.advance()
            if self.flags & SRE_REGEX_CASELESS:
                val.ranges = turn_char_class_caseless(val.ranges)
            return val
        self.error()


def _wrap_unanchored(parsed_alt):
    """Prefix the non-greedy unanchored scan loop:  .*?(re)
    (sre_regex_parse, sre_yyparser.y:1830-1857)."""
    star = Node(STAR, Node(DOT))   # greedy defaults to 0 => non-greedy
    return Node(CAT, star, parsed_alt)


def parse(src, flags=0):
    """Parse one regex.  Returns (ast_root, ncaps).

    The root is Cat(NgStar(Dot), TOPLEVEL(0, Paren(0, re))) with
    nregexes=1 / multi_ncaps=[ncaps], mirroring sre_regex_parse
    (sre_yyparser.y:1806-1867).  Raises ParseError on syntax errors.
    """
    if isinstance(src, str):
        src = src.encode("utf-8")
    p = _Parser(src, flags, 0)
    parsed = p.parse()

    paren = Node(PAREN, parsed)        # $0 capture, group 0
    top = Node(TOPLEVEL, paren)        # regex_id 0
    root = _wrap_unanchored(top)
    root.nregexes = 1
    root.multi_ncaps = [p.ncaps]
    return root, p.ncaps


def parse_multi(regexes, multi_flags=None):
    """Parse N regexes into one combined AST with continued capture
    numbering and per-regex TOPLEVEL ids chained by left-deep ALT
    (sre_regex_parse_multi, sre_yyparser.y:1871-1986).

    Returns (ast_root, max_ncaps).  ParseError carries regex_id.
    """
    nregexes = len(regexes)
    if nregexes <= 0:
        raise ValueError("no regexes")

    multi_ncaps = [0] * nregexes
    max_ncaps = 0
    ncaps = 0
    saved_ncaps = 0
    r = None

    for i, src in enumerate(regexes):
        if isinstance(src, str):
            src = src.encode("utf-8")
        flags = multi_flags[i] if multi_flags else 0
        group = ncaps
        p = _Parser(src, flags, ncaps)
        try:
            parsed = p.parse()
        except ParseError as e:
            e.regex_id = i
            raise
        ncaps = p.ncaps

        paren = Node(PAREN, parsed)
        paren.group = group            # this regex's $0 slot
        top = Node(TOPLEVEL, paren)
        top.regex_id = i

        if r is None:
            r = top
            multi_ncaps[i] = ncaps
            max_ncaps = ncaps
        else:
            r = Node(ALT, r, top)
            multi_ncaps[i] = ncaps - saved_ncaps
            if multi_ncaps[i] > max_ncaps:
                max_ncaps = multi_ncaps[i]

        ncaps += 1
        saved_ncaps = ncaps

    root = _wrap_unanchored(r)
    root.nregexes = nregexes
    root.multi_ncaps = multi_ncaps
    return root, max_ncaps
