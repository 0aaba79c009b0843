"""Time a hand kernel against variants of its source, side by side on
one card, at the main path's shape.

    python3 tools/time_kernel_variants.py KERNEL [VARIANT.cu ...]

KERNEL is affine, phi, narrow, big or gated.

Builds the tree's source ("tree": sregex_tpu_torch/csrc/affine_scan.cu,
phi_scan.cu, pair_scan.cu or big_scan.cu) and each VARIANT.cu alone
with nvcc (sm_90a, the package's flags) into build/kernel_variants/,
and prepares chip_smoke.py's input for the kernel:

  affine: the base64-blob detector's tables at the warmup the affine
    phase settles on (512) over its 1920 MB log-like corpus
    (SREGEX_BENCH_AFFINE_MB), every stream entered at state 0; timed
    COUNT, the templated kernel and the generic one;
  phi: b(?:aa)*b's lane-packed tables over the phi phase's 1920 MB of
    a-runs (SREGEX_BENCH_PHI_MB); timed COUNT at each k that fits
    (8, 4, 2, 1);
  narrow: the headline's tables (two-code table, 4-bit) over its 1920 MB
    corpus (SREGEX_BENCH_MB), entered as the scan folds enter it (every
    stream at state 0, stream 0 frozen through the warmup); timed in
    scan mode (the headline's) and COUNT;
  big: the 500-keyword dictionary's tables (16-bit table) over the big
    phase's 1920 MB corpus (SREGEX_BENCH_BIG_MB), entered the same way;
    timed COUNT (the big phase's) and in scan mode;
  gated: the dictionary's phase 2 on the fused tier (chip_smoke.py's core
    arm: the 16-bit route, its escapes over the same corpus); timed with
    the escaped chunks read in place through the slot map ("in_place"),
    on the same windows gathered first ("windows") and with one escape
    ("one_row").

For narrow and big the tree's one-lookup kernel (sre_spec_scan or
sre_big_scan, from the package's library) is timed beside them as the
source "one_lookup".  It checks that every source's planes equal the
plain version on the first 64 MB at every timed setting, then times
each with CUDA events, 20 launches a time, in the order tree, V1, ...
and back, twice.  Prints the card's name and power limit and one JSON
line {"kernel", "shape", "ms": {source: {setting: [ms per round]}}}.
Each VARIANT.cu must export the tree's entry point (sre_affine_scan,
sre_phi_scan, sre_spec_scan_pair, sre_big_scan_smem or sre_gated_scan)
with the tree's signature; it may include the package's csrc/*.cuh.
Needs a CUDA card.
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
from sregex_tpu_torch.ops import affine as aff  # noqa: E402
from sregex_tpu_torch.ops import big as tbig  # noqa: E402
from sregex_tpu_torch.ops import phi as tphi  # noqa: E402
from sregex_tpu_torch.ops import spec_scan as scan  # noqa: E402
from sregex_tpu_torch.ops.prep import prepare_on_device  # noqa: E402

PLAIN_MB = 64
SOURCES = {"affine": "affine_scan.cu", "phi": "phi_scan.cu",
           "narrow": "pair_scan.cu", "big": "big_scan.cu",
           "gated": "gated_scan.cu"}
CSRC = ROOT / "sregex_tpu_torch" / "csrc"
# argument types of each entry point a source may export
ARGTYPES = {
    "sre_affine_scan": "ppppipppiiiiiiippiip",
    "sre_phi_scan": "ppippiiiiiiiiiipiip",
    "sre_spec_scan_pair": "ppppipppiiiiiiipipip",
    "sre_big_scan_smem": "ppppipppiiiiiiipiiip",
    "sre_gated_scan": "ppppipppiiiiiippiipiiip",
}


def build(sources, out):
    """{name: ctypes library} of each source, compiled in parallel, with
    the package's argument types."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
         str(out / ("%s.so" % name)), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    ctype = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name, log))
        lib = ctypes.CDLL(str(out / ("%s.so" % name)))
        for entry, types in ARGTYPES.items():
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctype[c] for c in types]
        libs[name] = lib
    return libs


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def affine_case(libs):
    """(data, its first PLAIN_MB MB, {setting: run(name, data)}, the
    plain version, None: every slot is compared)."""
    sc = sregex_tpu_torch.compile_pattern(cs.BASE64_BLOB)
    t = scan.with_warmup(sc._spec, 512)
    corpus = cs.base64_corpus(cs.mb_env("SREGEX_BENCH_AFFINE_MB"))
    data = prepare_on_device(t, corpus, 2048)[0]
    del corpus
    K = (data.shape[1] * t.cpw - t.warmup)
    small = data[:-(-(PLAIN_MB << 20) // K // (cs.GROUPS * 1024))]
    kw = dict(W=t.warmup, CPW=t.cpw, BITS=t.bits, NCLS=t.ncls, OFF=t.off,
              COUNT=True)
    rel = t.relaid

    def runner(generic):
        def run(name, d):
            s0, j0 = scan._entry_planes(0, t.warmup, d.shape[0], d.device)
            out = tuple(torch.empty_like(s0) for _ in range(3))
            rc = libs[name].sre_affine_scan(
                d.data_ptr(), s0.data_ptr(), j0.data_ptr(),
                rel.table.data_ptr(), rel.table.numel(),
                *(o.data_ptr() for o in out), *d.shape[:3], t.warmup,
                t.cpw, t.bits, 1, rel.pieces.data_ptr(),
                ctypes.addressof(rel.host), len(rel.bp), int(generic),
                stream())
            if rc:
                raise RuntimeError("%s: cudaError %d" % (name, rc))
            return out
        return run

    def plain(d):
        s0, j0 = scan._entry_planes(0, t.warmup, d.shape[0], d.device)
        return aff.affine_scan_ref(d, s0, j0, t.fused, t.bp, **kw)

    return data, small, {"templated": runner(False),
                         "generic": runner(True)}, plain, None


def phi_case(libs):
    """As affine_case, with the valid slots to compare."""
    sc = sregex_tpu_torch.compile_pattern(cs.PHI_PATTERN)
    t = tphi.PhiTables(sc.dfa, "cuda")
    corpus = cs.run_corpus(cs.mb_env("SREGEX_BENCH_PHI_MB"), 60, 300, 0)
    data, _, K, WL, _, _ = tphi.phi_prepare(t, corpus, 2048)
    del corpus
    kw = dict(Kw=K // t.cpw, WL=WL, CPW=t.cpw, BITS=t.bits, S=t.nstates,
              NSEG=t.nseg, NCLS=t.ncls, COUNT=True)
    G = data.shape[2]
    small = data[:-(-(PLAIN_MB << 20) // K // (G * 8 * t.nseg))]
    ks = [k for k in (8, 4, 2, 1) if t.cpw % k == 0
          and t.nstates * t.ncls ** k + t.fused.numel() + 256
          <= tphi.STRIDE_SMEM_ENTRIES]

    def runner(k):
        def run(name, d):
            stk = t.stride(True, k)[1]
            phi = torch.empty((d.shape[0], G, 8, 128), dtype=torch.int32,
                              device=d.device)
            acc = torch.empty_like(phi)
            rc = libs[name].sre_phi_scan(
                d.data_ptr(), t.fused.data_ptr(), t.fused.numel(),
                phi.data_ptr(), acc.data_ptr(), *d.shape[:3], kw["Kw"], WL,
                t.bits, t.nstates, t.nseg, t.ncls, 1, stk.data_ptr(),
                stk.numel(), k, stream())
            if rc:
                raise RuntimeError("%s: cudaError %d" % (name, rc))
            return phi, acc
        return run

    def plain(d):
        return tphi.phi_scan_ref(d, t.fused, **kw)

    return data, small, {"k%d" % k: runner(k) for k in ks}, plain, \
        cs.phi_valid(kw, data.device)


def scan_case(libs, kernel):
    """As affine_case for the narrow (two-code) and big (16-bit) kernels:
    run(name, data) launches source ``name``'s kernel, or the package's
    one-lookup kernel for the name "one_lookup"."""
    if kernel == "narrow":
        ast, _ = sregex_tpu_torch.parse(cs.HEADLINE)
        t = scan.SpecTables(sregex_tpu_torch.build_dfa(
            sregex_tpu_torch.compile_regex(ast)), "cuda")
        corpus = cs.headline_corpus(cs.mb_env("SREGEX_BENCH_MB"))
        entry, one, extra = ("sre_spec_scan_pair", "sre_spec_scan",
                             (t.pair.table, t.pair.rowmap))
        plain_fn = scan.spec_scan_ref
    else:
        words = cs.dictionary(500)
        t = sregex_tpu_torch.compile_pattern(words)._spec
        corpus = cs.multi_corpus(cs.mb_env("SREGEX_BENCH_BIG_MB"), words)
        entry, one, extra = "sre_big_scan_smem", "sre_big_scan", None
        plain_fn = tbig.big_scan_ref
    data = prepare_on_device(t, corpus, 2048)[0]
    del corpus
    K = data.shape[1] * t.cpw - t.warmup
    small = data[:-(-(PLAIN_MB << 20) // K // (cs.GROUPS * 1024))]
    package = _build.load()

    def runner(count):
        def run(name, d):
            s0, j0 = scan._entry_planes(0, t.warmup, d.shape[0], d.device)
            out = tuple(torch.empty_like(s0) for _ in range(3))
            head = (d.data_ptr(), s0.data_ptr(), j0.data_ptr(),
                    t.fused.data_ptr(), t.fused.numel(),
                    *(o.data_ptr() for o in out), *d.shape[:3], t.warmup,
                    t.cpw, t.bits, int(count))
            if name == "one_lookup":
                rc = getattr(package, one)(*head, stream())
            elif extra is not None:
                rc = getattr(libs[name], entry)(
                    *head, extra[0].data_ptr(), extra[0].numel(),
                    extra[1].data_ptr(), extra[1].numel(), stream())
            else:
                rc = getattr(libs[name], entry)(
                    *head, t.t16.table.data_ptr(), t.t16.table.numel(),
                    t.t16.ncls, t.t16.rows, stream())
            if rc:
                raise RuntimeError("%s: cudaError %d" % (name, rc))
            return out
        return run

    settings = ((("scan", False), ("count", True)) if kernel == "narrow"
                else (("count", True), ("scan", False)))
    runs = {name: runner(count) for name, count in settings}

    def plain(d, setting):
        s0, j0 = scan._entry_planes(0, t.warmup, d.shape[0], d.device)
        return plain_fn(d, s0, j0, t.fused, W=t.warmup, CPW=t.cpw,
                        BITS=t.bits, COUNT=dict(settings)[setting])

    return data, small, runs, plain, None


def gated_case(libs):
    """As scan_case for the gated kernel: the dictionary's fused Scanner
    over the big phase's corpus, phase 1 and the escape compaction run
    once; run(name, _) launches source ``name``'s sre_gated_scan on the
    16-bit route into zeroed planes (the plain version's inactive rows)."""
    from sregex_tpu_torch.ops import core as tcore
    words = cs.dictionary(500)
    corpus = cs.multi_corpus(cs.mb_env("SREGEX_BENCH_BIG_MB"), words)
    with cs.env("SREGEX_FUSED", "1"):
        sc = sregex_tpu_torch.compile_pattern(words)
        prep = sc.prepare(corpus)
        sc.count(corpus, prepared=prep)
    fct, full = sc._fusedct, sc._spec
    inner = fct.inner
    ck = tcore.fused_chunk(inner, full)
    cdata, C, K, _, B1 = prep.for_tables(inner, ck)
    fdata = prep.for_tables(full, ck)[0]
    n = len(corpus)
    del corpus
    Cfull = C - 1 if C * K > n and n - (C - 1) * K != K else C
    cap = tcore._fused_cap(B1)
    Cp = B1 * cs.GROUPS * 1024
    s01, j01 = scan._entry_planes(fct.to_core_premult(0), inner.warmup, B1,
                                  "cuda")
    phi1 = scan.spec_scan(cdata, s01, j01, inner.fused, W=inner.warmup,
                          CPW=inner.cpw, BITS=inner.bits, COUNT=True)[0]
    live = torch.arange(Cp, device="cuda") < Cfull
    n_esc, _, sel, _ = tcore._compact_escapes(phi1.reshape(Cp), live,
                                              fct.esc_premult, cap)
    del cdata, phi1, s01, j01
    blk = tcore._gather_windows(fdata, sel, cap)
    z = torch.zeros((cap // (cs.GROUPS * 1024), cs.GROUPS, 8, 128),
                    dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    tt = full.t16
    kw = dict(W=full.warmup, CPW=full.cpw, BITS=full.bits)

    def runner(d, ne, mapped):
        def run(name, _):
            out = tuple(torch.zeros_like(z) for _ in range(3))
            rc = libs[name].sre_gated_scan(
                d.data_ptr(), z.data_ptr(), z.data_ptr(),
                full.fused.data_ptr(), full.fused.numel(),
                *(o.data_ptr() for o in out), z.shape[0], *d.shape[1:3],
                full.warmup, full.cpw, full.bits, ne.data_ptr(),
                sel.data_ptr() if mapped else None, d[:, 0].numel(),
                tcore.GATED_ROUTES.index("big16"), tt.table.data_ptr(),
                tt.table.numel(), tt.ncls, tt.rows, stream())
            if rc:
                raise RuntimeError("%s: cudaError %d" % (name, rc))
            return out
        return run

    runs = {"in_place": runner(fdata, n_esc, True),
            "windows": runner(blk, n_esc, False),
            "one_row": runner(fdata, one, True)}
    ne_of = {"in_place": n_esc, "windows": n_esc, "one_row": one}

    def plain(_, setting):
        return tcore.gated_scan_ref(fdata, z, z, full.fused,
                                    ne_of[setting], sel=sel, **kw)

    print(json.dumps({"gated_case": list(fdata.shape),
                      "n_esc": int(n_esc), "cap": cap}), flush=True)
    return fdata, fdata, runs, plain, None


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    kernel = sys.argv[1]
    sources = {"tree": ROOT / "sregex_tpu_torch" / "csrc" / SOURCES[kernel]}
    for arg in sys.argv[2:]:
        sources[Path(arg).stem] = Path(arg).resolve()
    libs = build(sources, ROOT / "build" / "kernel_variants")
    if kernel in ("narrow", "big"):
        data, small, runs, plain, valid = scan_case(libs, kernel)
        sources["one_lookup"] = None
        want = {setting: plain(small, setting) for setting in runs}
    elif kernel == "gated":
        data, small, runs, plain, valid = gated_case(libs)
        want = {setting: plain(small, setting) for setting in runs}
    else:
        data, small, runs, plain, valid = (affine_case if kernel == "affine"
                                           else phi_case)(libs)
        want = dict.fromkeys(runs, plain(small))
    for name in sources:
        for setting, run in runs.items():
            got = run(name, small)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) if valid is None else
                       torch.equal(g[..., valid], w[..., valid])
                       for g, w in zip(got, want[setting])):
                raise AssertionError("%s (%s) differs from the plain version"
                                     % (name, setting))
    names = list(sources)
    ms = {name: {setting: [] for setting in runs} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            for setting, run in runs.items():
                ms[name][setting].append(cs.time_gpu(
                    lambda: run(name, data), 20))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(json.dumps({"kernel": kernel, "shape": list(data.shape),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
