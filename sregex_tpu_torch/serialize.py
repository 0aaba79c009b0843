"""Compiled-pattern serialization: compile once, ship to workers.

Production serving compiles a pattern set once (parse + NFA emission +
eager subset construction can cost seconds for big automata) and fans
the tables out to many scan workers; this module round-trips the
compiled Program (the Pike/Thompson bytecode) and the dense DFA tables
through one .npz file (arrays + a JSON header).  Net-new vs the
reference, which recompiles per process (sregex.h has no persistence
API).

    from sregex_tpu_torch.serialize import save_compiled, load_compiled
    save_compiled("p.sre.npz", scanner)
    sc = load_compiled("p.sre.npz")         # a ready Scanner on the card

Format v1, the JAX package's: a file either package writes loads in the
other.  The DFA tables are optional (patterns past the eager budget
serialize the program alone and rebuild the lazy machine on load).
"""

import io
import json

import numpy as np

from .bytecode import Instruction, Program

_VERSION = 1


def _program_to_dict(prog):
    insts = []
    for ins in prog.insts:
        insts.append([ins.opcode, ins.x, ins.y, ins.ch,
                      ins.ranges, ins.group, ins.assertion,
                      ins.regex_id])
    return {
        "insts": insts,
        "nullable": prog.nullable,
        "leading_bytes": prog.leading_bytes,
        "leading_byte": prog.leading_byte,
        "ovecsize": prog.ovecsize,
        "nregexes": prog.nregexes,
        "multi_ncaps": list(prog.multi_ncaps),
        "lookahead_asserts": prog.lookahead_asserts,
        "uniq_threads": prog.uniq_threads,
        "dup_threads": prog.dup_threads,
    }


def _program_from_dict(d):
    prog = Program()
    for row in d["insts"]:
        ins = Instruction()
        (ins.opcode, ins.x, ins.y, ins.ch, ranges, ins.group,
         ins.assertion, ins.regex_id) = row
        ins.ranges = ([tuple(r) for r in ranges]
                      if ranges is not None else None)
        prog.insts.append(ins)
    prog.nullable = d["nullable"]
    prog.leading_bytes = d["leading_bytes"]
    prog.leading_byte = d["leading_byte"]
    prog.ovecsize = d["ovecsize"]
    prog.nregexes = d["nregexes"]
    prog.multi_ncaps = list(d["multi_ncaps"])
    prog.lookahead_asserts = d["lookahead_asserts"]
    prog.uniq_threads = d["uniq_threads"]
    prog.dup_threads = d["dup_threads"]
    return prog


def save_compiled(path, scanner_or_prog, dfa=None):
    """Serialize a Scanner (or a bare Program [+ Dfa]) to ``path``."""
    from .stream import Scanner
    if isinstance(scanner_or_prog, Scanner):
        prog = scanner_or_prog.program
        dfa = scanner_or_prog.dfa if dfa is None else dfa
    else:
        prog = scanner_or_prog
    header = {
        "version": _VERSION,
        "program": _program_to_dict(prog),
        "has_dfa": dfa is not None,
    }
    arrays = {"header": np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)}
    if dfa is not None:
        arrays.update(
            trans=dfa.trans, match_id=dfa.match_id,
            match_eof_id=dfa.match_eof_id, class_map=dfa.class_map)
        if dfa.sterile is not None:
            arrays.update(sterile=dfa.sterile)
    if hasattr(path, "write"):
        np.savez_compressed(path, **arrays)
    else:
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)


def load_compiled(path, device="cuda"):
    """Load a Scanner on ``device`` (the card by default; "cpu" for the
    plain versions, None for the host engines alone) from a
    save_compiled file.  The DFA tables are reused as-saved (no subset
    construction); find() falls back to the Pike window without the
    reverse automaton (that needs the AST — recompile from source if
    reverse-scan find speed matters)."""
    from .dfa import Dfa
    from .stream import Scanner
    with np.load(path if not hasattr(path, "read") else path,
                 allow_pickle=False) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["version"] != _VERSION:
            raise ValueError("unsupported version %r"
                             % header["version"])
        prog = _program_from_dict(header["program"])
        dfa = None
        if header["has_dfa"]:
            dfa = Dfa(prog, z["trans"].copy(),
                      z["match_id"].copy(),
                      z["match_eof_id"].copy(),
                      z["class_map"].copy(),
                      sterile=z["sterile"].copy()
                      if "sterile" in z else None)
    return Scanner(prog, device=device, ast=None, dfa=dfa)
