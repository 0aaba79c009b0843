"""Time the tagged-DFA kernel against variants of its source, side by
side on one card, at the find phase of chip_smoke.py.

    python3 tools/time_tdfa_variants.py [VARIANT.cu ...]

Builds sregex_tpu_torch/csrc/tdfa_scan.cu ("tree") and each VARIANT.cu
alone with nvcc (sm_90a, the package's flags) into build/tdfa_variants/,
prepares chip_smoke.py's find corpus (SREGEX_BENCH_FIND_MB, default
1920) and machine, checks that every variant's planes equal the tree's
and the tree's equal the plain version (tdfa_scan_ref), then times each
source with CUDA events, 20 launches a time, in the order tree, V1, ...
and back, four rounds.  Prints the card's name and power limit and one
JSON line {"shape", "ms": {source: [ms per round]}}.  Needs a CUDA card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import sregex_tpu_torch  # noqa: E402
from sregex_tpu_torch.ops import _build  # noqa: E402
from sregex_tpu_torch.ops import tdfa_scan as tdfa  # noqa: E402


def build(sources, out):
    """{name: ctypes library} of each source, compiled in parallel."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
         str(out / ("%s.so" % name)), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name, log))
        lib = ctypes.CDLL(str(out / ("%s.so" % name)))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.sre_tdfa_scan.restype = i
        lib.sre_tdfa_scan.argtypes = [ptr] * 7 + [i] * 3 + [ptr] * 4 \
            + [i] * 9 + [ptr]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    sources = {"tree": ROOT / "sregex_tpu_torch" / "csrc" / "tdfa_scan.cu"}
    for arg in sys.argv[1:]:
        sources[Path(arg).stem] = Path(arg).resolve()
    libs = build(sources, ROOT / "build" / "tdfa_variants")

    sc = sregex_tpu_torch.compile_pattern(cs.FIND_PATTERN)
    ft = sc._tdfa_spec
    corpus = cs.log_corpus(cs.mb_env("SREGEX_BENCH_FIND_MB"))
    cs.plant_line(corpus, len(corpus) - 8192, cs.FIND_PLANT)
    data = sc.prepare(bytes(corpus)).for_tables(ft)[0]
    del corpus
    s0 = torch.full((data.shape[0], cs.GROUPS, 8, 128), ft.seed_premult,
                    dtype=torch.int32, device=data.device)
    j0 = torch.zeros_like(s0)
    j0[0, 0, 0, 0] = ft.warmup
    tabs, kw = ft.planes()
    B, Jw, G = data.shape[:3]

    def run(name):
        phi, swarm = torch.empty_like(s0), torch.empty_like(s0)
        bank = s0.new_empty((kw["T"] + 1,) + tuple(s0.shape))
        regs = s0.new_empty((kw["R"],) + tuple(s0.shape))
        rc = libs[name].sre_tdfa_scan(
            data.data_ptr(), s0.data_ptr(), j0.data_ptr(),
            *(t.data_ptr() for t in tabs), tabs[0].numel(),
            tabs[1].shape[0], tabs[2].shape[0], phi.data_ptr(),
            swarm.data_ptr(), bank.data_ptr(), regs.data_ptr(), B, Jw, G,
            kw["W"], kw["CPW"], kw["BITS"], kw["CODE"], kw["R"], kw["T"],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError("%s: cudaError %d" % (name, rc))
        return phi, swarm, bank, regs

    want = tdfa.tdfa_scan_ref(data, s0, j0, *tabs, **kw)
    for name in sources:
        got = run(name)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("%s differs from the plain version" % name)
    names = list(sources)
    ms = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            ms[name].append(cs.time_gpu(lambda: run(name), 20))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"shape": list(data.shape), **kw, "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
