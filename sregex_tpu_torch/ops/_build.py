"""Build and load the CUDA kernels of the package.

The kernels are CUDA C++ with a plain C interface
(sregex_tpu_torch/csrc/*.cu, with the step helpers they share in
csrc/*.cuh).  At first use every source is compiled
with ``nvcc`` for sm_90a, one process per source, all at once; the
objects are linked into one shared library under build/sregex_tpu_torch/
at the repository root, named after a hash of the sources so an edit
rebuilds it, and loaded with ctypes.  Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
_HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "sregex_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas registers / shared memory per
# kernel) and how long it took; None when the library was cached
build_log = None
build_seconds = None


def find_nvcc():
    """nvcc from PATH, else $CUDA_HOME/bin (CUDA_HOME defaults to
    /usr/local/cuda).  Raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin (%s): the CUDA "
        "kernels of sregex_tpu_torch cannot be built" % cand)


def _library_path():
    h = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("libsregex_kernels-%s.so" % h.hexdigest()[:16])


def _compile(so):
    global build_log, build_seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        objs = [tmp / (src.stem + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed (%s):\n%s" % (
                [p.returncode for p in procs], log))
        link = tmp / so.name
        r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(link),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s%s"
                               % (r.returncode, r.stdout, r.stderr))
        os.replace(link, so)       # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = log


def load():
    """The kernel library (ctypes.CDLL), built on first use.  Raises
    when nvcc is missing or the build fails; there is no fallback."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.sre_spec_scan, lib.sre_big_scan):
            fn.restype = i
            fn.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, i, i, i, p]
        lib.sre_spec_scan_pair.restype = i
        lib.sre_spec_scan_pair.argtypes = [p, p, p, p, i, p, p, p, i, i, i,
                                           i, i, i, i, p, i, p, i, p]
        lib.sre_big_scan_smem.restype = i
        lib.sre_big_scan_smem.argtypes = [p, p, p, p, i, p, p, p, i, i, i,
                                          i, i, i, i, p, i, i, i, p]
        lib.sre_gated_scan.restype = i
        lib.sre_gated_scan.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, i,
                                       i, p, p, i, i, p, i, i, i, p]
        lib.sre_affine_scan.restype = i
        lib.sre_affine_scan.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i,
                                        i, i, i, p, p, i, i, p]
        lib.sre_tdfa_scan.restype = i
        lib.sre_tdfa_scan.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p,
                                      p, i, i, i, i, i, i, i, i, i, p]
        lib.sre_phi_scan.restype = i
        lib.sre_phi_scan.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i, i,
                                     i, i, p, i, i, p]
        lib.sre_phi_big_scan.restype = i
        lib.sre_phi_big_scan.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i,
                                         i, i, p, i, i, p]
        lib.sre_spec_summary.restype = i
        lib.sre_spec_summary.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p,
                                         p, p, i, p]
        _lib = lib
        return _lib
