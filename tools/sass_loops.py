"""Dump the SASS of chosen kernels and count the instructions of their
loops, to read what one inner step of a kernel costs.

    python3 tools/sass_loops.py OUT_DIR SOURCE.cu:KERNEL_SUBSTRING ...

Compiles each SOURCE.cu to a cubin with nvcc (sm_90a, the package's
flags), disassembles it with cuobjdump -sass, demangles the function
names with cu++filt, and for every function whose demangled name
contains KERNEL_SUBSTRING (compared without spaces or casts, true and
false as 1 and 0) writes its SASS to OUT_DIR/<n>.sass and prints one
JSON line: the function, its instruction count, ptxas's register
report, and for
each loop (a branch back to an earlier address) the loop's address
range, its instruction count, its shared-memory loads (LDS) and its
opcodes by count.  A loop's count includes every branch inside it
(e.g. a rare slow path); read the dumped SASS to split those off.
Where no function matches, the line lists the source's functions.
Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt).  The inner loops
of the two-code and 16-bit scans, for example:

    python3 tools/sass_loops.py sass \
        "sregex_tpu_torch/csrc/pair_scan.cu:spec_pair_kernel<4, 0>" \
        "sregex_tpu_torch/csrc/big_scan.cu:big_smem_kernel<8, 1>"

(the scan-mode narrow kernel and the COUNT-mode 8-bit big kernel; the
main loop of the first is the one with 8 LDS, of the second the one
with 16 LDS.U16, two streams of 4 codes a word, two words a turn).
"""

import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sregex_tpu_torch.ops import _build  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def functions(sass):
    """{mangled name: [(address, instruction text)]} of a cuobjdump."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text):
    """The opcode of an instruction, without its predicate or modifiers'
    operands (LDS.64 stays LDS.64)."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def loops(insns):
    """Each backward branch's [target, branch] range with its counts."""
    found = []
    for addr, text in insns:
        m = _BRA.search(text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [t for a, t in insns if lo <= a <= addr]
        ops = collections.Counter(opcode(t) for t in body)
        found.append({"range": [hex(lo), hex(addr)], "insns": len(body),
                      "lds": sum(n for o, n in ops.items()
                                 if o.startswith("LDS")),
                      "ops": dict(ops.most_common())})
    return found


def _norm(name):
    """A demangled name in one spelling: no spaces, no casts in template
    arguments ((int)4 -> 4), true/false as 1/0."""
    name = re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", name)
    return name.replace(" ", "").replace("true", "1").replace("false", "0")


def main():
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    bindir = Path(nvcc).parent
    n = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, arg in enumerate(sys.argv[2:]):
            src, want = arg.rsplit(":", 1)
            cubin = Path(tmp) / ("k%d.cubin" % i)
            built = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-I",
                 str(ROOT / "sregex_tpu_torch" / "csrc"), "-cubin", "-o",
                 str(cubin), src], check=True, capture_output=True,
                text=True)
            ptxas = (built.stdout + built.stderr).splitlines()
            sass = subprocess.run([str(bindir / "cuobjdump"), "-sass",
                                   str(cubin)], check=True,
                                  capture_output=True, text=True).stdout
            names, matched = [], False
            for name, insns in functions(sass).items():
                demangled = subprocess.run(
                    [str(bindir / "cu++filt"), name], capture_output=True,
                    text=True).stdout.strip() or name
                names.append(demangled)
                if _norm(want) not in _norm(demangled):
                    continue
                path = out_dir / ("%d.sass" % n)
                path.write_text("// %s\n// %s\n%s" % (
                    src, demangled,
                    "\n".join("/*%04x*/ %s;" % (a, t) for a, t in insns)))
                # ptxas's report for this function: its "Used ..." line,
                # between the line that starts compiling it and the next
                report, inside = [], False
                for line in ptxas:
                    if "Compiling entry function" in line:
                        inside = name in line
                    elif inside and "Used" in line:
                        report.append(line.split(":", 1)[-1].strip())
                print(json.dumps({"source": src, "function": demangled,
                                  "file": str(path), "insns": len(insns),
                                  "ptxas": report, "loops": loops(insns)}),
                      flush=True)
                n += 1
                matched = True
            if not matched:
                print(json.dumps({"source": src, "no_match": want,
                                  "functions": names}), flush=True)


if __name__ == "__main__":
    main()
