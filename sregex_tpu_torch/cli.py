"""sregex-cli compatible command-line front end.

Reimplements the reference CLI's exact output contract
(reference src/sre_cli.c): AST + bytecode dumps, `captures:`
line, `--stdin` length-prefixed framing (:213-259), and per subject the
six labeled engine-mode lines (:298-660):

    thompson / splitted thompson          (streaming Thompson VM)
    jitted thompson / splitted jitted ... (DFA table engine — our
                                           successor of the x64 JIT)
    pike / splitted pike                  (streaming Pike VM)

"splitted" modes feed the stream byte-at-a-time with zero-length
non-EOF chunks interleaved between bytes (:364-413), exercising the
resumable-state carry on every test.
"""

import sys

from .consts import (
    SRE_OK, SRE_ERROR, SRE_AGAIN, SRE_DECLINED, SRE_REGEX_CASELESS,
)
from .parser import parse, parse_multi, ParseError
from .compiler import compile_regex
from .ast_nodes import dump_str
from .bytecode import dump_program
from .pike_vm import PikeCtx
from .thompson_vm import ThompsonCtx


def _parse_regex_flags(flags_str, nregexes):
    """--flags parsing (sre_cli.c:676-711): space-separated per-regex
    groups; only 'i' is supported.  Returns (errmsg, list)."""
    multi_flags = [0] * nregexes
    i = 0
    for ch in flags_str:
        if i >= nregexes:
            return ("Too many flags given but only %d regexes "
                    "specified.\n" % nregexes, None)
        if ch == 0x20:
            i += 1
        elif ch == 0x69:  # 'i'
            multi_flags[i] |= SRE_REGEX_CASELESS
        else:
            return ("Bad regex flag '%c' for regex %d\n" % (chr(ch), i),
                    None)
    return (None, multi_flags)


class _Out:
    def __init__(self, stdout, stderr):
        self.stdout = stdout
        self.stderr = stderr

    def out(self, s):
        self.stdout.write(s if isinstance(s, bytes) else s.encode("latin-1"))

    def err(self, s):
        self.stderr.write(s if isinstance(s, bytes) else s.encode("latin-1"))


def _thompson_result(rc):
    if rc == SRE_OK:
        return "match\n"
    if rc == SRE_DECLINED:
        return "no match\n"
    if rc == SRE_AGAIN:
        return "again\n"
    return "error\n"


def _pike_print(o, rc, ovector, ncaps):
    if rc >= 0:
        o.out("match %d" % rc)
        for i in range(0, 2 * (ncaps + 1), 2):
            o.out(" (%d, %d)" % (ovector[i], ovector[i + 1]))
        o.out("\n")
    elif rc == SRE_AGAIN:
        o.out("again\n")
    elif rc == SRE_DECLINED:
        o.out("no match\n")
    elif rc == SRE_ERROR:
        o.out("error\n")
    else:
        o.out("unknown (%d)\n" % rc)


def _splitted(exec_one, length):
    """Drive an engine byte-at-a-time with interleaved zero-length
    non-EOF chunks (sre_cli.c:364-413).  ``exec_one(i_or_None, eof)``
    runs one chunk; yields (rc, i) after each call."""
    gen_empty = True
    i = 0
    while i <= length:
        if i == length:
            yield exec_one(None, True), i
            return
        elif gen_empty:
            rc = exec_one(None, False)
            gen_empty = False
            yield rc, -1
        else:
            rc = exec_one(i, False)
            gen_empty = True
            yield rc, i
            i += 1


def _process_string(o, s, prog, ncaps, dfa=None):
    """One subject through all six engine modes (sre_cli.c:298-660)."""
    # C printf("%.*s") stops at a NUL byte even with an explicit
    # precision — replicate (sre_cli.c:311)
    o.out(b"## " + s.split(b"\0")[0] + (" (len %d)\n" % len(s)).encode())

    # Thompson, whole buffer
    o.out("thompson ")
    tctx = ThompsonCtx(prog)
    o.out(_thompson_result(tctx.exec(s, True)))

    # Splitted Thompson
    o.out("splitted thompson ")
    tctx = ThompsonCtx(prog)

    def texec(i, eof):
        return tctx.exec(None if i is None else s[i:i + 1], eof)

    for rc, _ in _splitted(texec, len(s)):
        if rc == SRE_AGAIN:
            continue
        o.out(_thompson_result(rc))
        break

    # "JITted" Thompson: the DFA table engine (our AOT successor of the
    # reference's DynASM x64 JIT).  Prints "disabled" when the table
    # compiler declines (mirroring SRE_DECLINED on non-x64,
    # sre_vm_thompson_jit.c:43-44).
    if dfa is None:
        o.out("jitted thompson disabled\n")
        o.out("splitted jitted thompson disabled\n")
    else:
        o.out("jitted thompson ")
        dctx = dfa.create_ctx()
        o.out(_thompson_result(dctx.exec(s, True)))

        o.out("splitted jitted thompson ")
        dctx = dfa.create_ctx()

        def dexec(i, eof):
            return dctx.exec(None if i is None else s[i:i + 1], eof)

        for rc, _ in _splitted(dexec, len(s)):
            if rc == SRE_AGAIN:
                continue
            o.out(_thompson_result(rc))
            break

    # Pike, whole buffer.  Engine selectable: the Python oracle VM or
    # the native C++ engine (SREGEX_PIKE_ENGINE=native), which share
    # the exec protocol and ovector semantics.
    import os as _os

    def make_pike():
        if _os.environ.get("SREGEX_PIKE_ENGINE") == "native":
            from .native_pike import NativePikeCtx
            return NativePikeCtx(prog, ovecsize=2 * (ncaps + 1))
        return PikeCtx(prog, [-1] * (2 * (ncaps + 1)))

    o.out("pike ")
    pctx = make_pike()
    ovector = pctx.ovector
    rc, _ = pctx.exec(s, True)
    _pike_print(o, rc, ovector, ncaps)

    # Splitted Pike
    o.out("splitted pike ")
    pctx = make_pike()
    ovector = pctx.ovector

    final_rc = None
    gen_empty = True
    i = 0
    while i <= len(s):
        if i == len(s):
            rc, pending = pctx.exec(None, True, True)
        elif gen_empty:
            rc, pending = pctx.exec(None, False, False)
            gen_empty = False
            if rc == SRE_AGAIN:
                continue
        else:
            rc, pending = pctx.exec(s[i:i + 1], False, True)
            if rc == SRE_AGAIN:
                o.out("[(%d, %d)]" % (ovector[0], ovector[1]))
                if pending is not None:
                    o.out("(%d, %d) " % (pending[0], pending[1]))
                else:
                    o.out(" ")
            gen_empty = True
            i += 1
            if rc == SRE_AGAIN:
                continue
        final_rc = rc
        break
    _pike_print(o, final_rc, ovector, ncaps)


def main(argv=None, stdin=None, stdout=None, stderr=None, use_dfa=True):
    """CLI entry point; returns the exit code.  All I/O is via byte
    streams so tests can run it in-process."""
    import os
    if argv is None:
        argv = sys.argv
    # normalize argv to raw bytes (the C CLI sees raw argv bytes)
    argv = [a if isinstance(a, bytes) else os.fsencode(a) for a in argv]
    if stdin is None:
        stdin = sys.stdin.buffer
    if stdout is None:
        stdout = sys.stdout.buffer
    if stderr is None:
        stderr = sys.stderr.buffer
    o = _Out(stdout, stderr)

    if len(argv) < 2:
        o.err("usage: sregex-cli regexp string...\n"
              "       sregex-cli --stdin regexp\n")
        return 2

    from_stdin = False
    flags_str = None
    nregexes = 1
    i = 1
    while i < len(argv):
        a = argv[i]
        if not a.startswith(b"-"):
            break
        if a.startswith(b"--stdin"):
            from_stdin = True
        elif a.startswith(b"--flags"):
            if i == len(argv) - 1:
                o.err("--flags should take a value.\n")
                return 1
            i += 1
            flags_str = argv[i]
        elif a.startswith(b"-n"):
            if i == len(argv) - 1:
                o.err("-n should take a value.\n")
                return 1
            i += 1
            try:
                nregexes = int(argv[i].decode("latin-1"))
            except ValueError:
                nregexes = 0
            if nregexes <= 0:
                o.err(b"invalid -n value: " + argv[i] + b".\n")
                return 1
        else:
            o.err(b"unknown option: " + a + b"\n")
            return 1
        i += 1

    multi_flags = None
    if flags_str is not None:
        errmsg, multi_flags = _parse_regex_flags(flags_str, nregexes)
        if errmsg is not None:
            o.err(errmsg)
            o.err(b"Bad --flags option value: " + flags_str)
            return 1

    if nregexes == 1:
        if i >= len(argv):
            o.err("usage: sregex-cli regexp string...\n"
                  "       sregex-cli --stdin regexp\n")
            return 2
        try:
            ast, ncaps = parse(argv[i],
                               multi_flags[0] if multi_flags else 0)
        except ParseError as e:
            o.err("[error] syntax error at pos %d\n" % e.offset)
            return 1
        i += 1
    else:
        if len(argv) - i < nregexes:
            o.err("at least %d regexes should be specified\n" % nregexes)
            return 1
        try:
            ast, ncaps = parse_multi(argv[i:i + nregexes], multi_flags)
        except ParseError as e:
            o.err("[error] regex %d: syntax error at pos %d\n"
                  % (e.regex_id, e.offset))
            return 1
        i += nregexes

    o.out(dump_str(ast) + "\n")
    o.out("captures: %d\n" % ncaps)

    prog = compile_regex(ast)
    o.out(dump_program(prog))

    # The table engine behind the "jitted thompson" lines is the LAZY
    # DFA: states materialize per observed byte, so a pathological
    # pattern costs nothing up front (eager build_dfa could stall for
    # seconds before the first output line) and no pattern is ever
    # "disabled" — matching the reference JIT's universality
    # (sre_vm_thompson_jit.c:39 compiles every program).
    dfa = None
    if use_dfa:
        try:
            from .dfa import LazyDfa
            dfa = LazyDfa(prog)
        except Exception:
            dfa = None

    if from_stdin:
        data = stdin.read()
        pos = 0
        while True:
            # frame: "<len>\n<bytes>" (sre_cli.c:213-259); scanf-style
            # integer scan skips leading whitespace
            while pos < len(data) and data[pos:pos + 1].isspace():
                pos += 1
            j = pos
            neg = False
            if j < len(data) and data[j:j + 1] in (b'-', b'+'):
                neg = data[j:j + 1] == b'-'
                j += 1
            k = j
            while k < len(data) and 48 <= data[k] <= 57:
                k += 1
            if k == j:
                break
            length = int(data[pos:k])
            pos = k
            if pos >= len(data) or data[pos] != 10:
                o.err("the next character after the chunk size "
                      "must be a newline")
                return 1
            pos += 1
            s = data[pos:pos + length]
            pos += length
            if len(s) < length:
                o.err("failed to read %d bytes of string from "
                      "stdin (only read %d bytes)." % (length, len(s)))
                return 2
            _process_string(o, s, prog, ncaps, dfa)
    else:
        if i >= len(argv):
            o.err("no subject string specified.\n")
            return 1
        for j in range(i, len(argv)):
            _process_string(o, argv[j], prog, ncaps, dfa)

    return 0


def run_main():
    sys.exit(main())


if __name__ == "__main__":
    run_main()
