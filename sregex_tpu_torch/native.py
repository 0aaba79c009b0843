"""ctypes bindings for the native host runtime (csrc/sre_host.cpp).

Builds the shared library on first use with g++ (cached under
build/sregex_tpu_torch/ at the repository root); all entry points
degrade gracefully to pure-Python/numpy fallbacks when no compiler is
available.
"""

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc", "sre_host.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "build", "sregex_tpu_torch")
_SO = os.path.join(_BUILD, "libsrehost.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    # build beside the target and rename: concurrent processes (test
    # workers) never load a half-written library
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
           "-fPIC", "-o", tmp, _CSRC]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_CSRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except Exception:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sre_dfa_scan_first.restype = ctypes.c_int64
        lib.sre_dfa_scan_first.argtypes = [i32p, u8p, ctypes.c_int64,
                                           i32p]
        lib.sre_dfa_count.restype = ctypes.c_int64
        lib.sre_dfa_count.argtypes = [i32p, u8p, ctypes.c_int64, i32p]
        lib.sre_dfa_scan_last.restype = ctypes.c_int64
        lib.sre_dfa_scan_last.argtypes = [i32p, u8p, ctypes.c_int64,
                                          i32p]
        lib.sre_dfa_transfer.restype = None
        lib.sre_dfa_transfer.argtypes = [i32p, ctypes.c_int32, u8p,
                                         ctypes.c_int64, i32p, i64p]
        lib.sre_dfa_visits.restype = None
        lib.sre_dfa_visits.argtypes = [i32p, u8p, ctypes.c_int64,
                                       i32p, i64p]
        lib.sre_find_first_byte.restype = ctypes.c_int64
        lib.sre_find_first_byte.argtypes = [u8p, u8p, ctypes.c_int64]
        for name in ("sre_lazy_count", "sre_lazy_scan_first",
                     "sre_lazy_scan_last"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [i64p, ctypes.c_int32, u8p, u8p,
                           ctypes.c_int64, i32p, i64p]
        lib.sre_pack_prepare.restype = None
        lib.sre_pack_prepare.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, i32p]
        _lib = lib
        return _lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeDfa:
    """Host-native scanner over a Dfa's fused tables.  The fused table
    is state-major [S, 256] int32 with the match bit in bit 20 (same
    encoding as the device tables, ops/spec_scan.py)."""

    def __init__(self, dfa):
        self.dfa = dfa
        trans = dfa.trans_bytes.astype(np.int32)
        match = dfa.match_bytes.astype(np.int32)
        self.fused = np.ascontiguousarray(trans | (match << 20))
        self.match_eof = dfa.match_eof
        self.lib = get_lib()

    def scan_first_id(self, data, state=0):
        """Like scan_first but also resolves WHICH regex matched:
        returns (boundary or -1, regex_id or -1, state_after).  The id
        is a single host table lookup at the boundary state — it never
        rides the scan loop (sre_vm_pike.c:607-658 reports the id of
        the first matching thread in priority order; the DFA's
        match_id table encodes exactly that per (state, class))."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        r, s = self.scan_first(buf, state)
        if r < 0:
            return r, -1, s
        return r, self.dfa.id_at(s, buf[r]), s

    def scan_first(self, data, state=0):
        """Returns (first_match_boundary or -1, state_after).  The EOF
        boundary is not checked here (see match_eof).  On a match the
        returned state is the state AT the boundary (the match id is
        dfa.id_at(state, data[boundary]))."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if self.lib is not None:
            st = np.array([state], dtype=np.int32)
            r = self.lib.sre_dfa_scan_first(
                _i32p(self.fused), _u8p(buf), len(buf), _i32p(st))
            return int(r), int(st[0])
        # numpy fallback (slow path)
        s = state
        fused = self.fused
        for i, b in enumerate(buf):
            e = fused[s, b]
            if e >> 20:
                return i, s
            s = e & 0xFFFFF
        return -1, s

    def scan_last(self, data, state=0):
        """Returns (last_match_boundary or -1, state_after_buffer)."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if self.lib is not None:
            st = np.array([state], dtype=np.int32)
            r = self.lib.sre_dfa_scan_last(
                _i32p(self.fused), _u8p(buf), len(buf), _i32p(st))
            return int(r), int(st[0])
        s = state
        last = -1
        fused = self.fused
        for i, b in enumerate(buf):
            e = fused[s, b]
            if e >> 20:
                last = i
            s = e & 0xFFFFF
        return last, s

    def count(self, data, state=0):
        """Count match-ending boundaries inside data (EOF excluded).
        Returns (count, state_after)."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if self.lib is not None:
            st = np.array([state], dtype=np.int32)
            r = self.lib.sre_dfa_count(
                _i32p(self.fused), _u8p(buf), len(buf), _i32p(st))
            return int(r), int(st[0])
        s = state
        cnt = 0
        fused = self.fused
        for b in buf:
            e = fused[s, b]
            cnt += int(e >> 20)
            s = e & 0xFFFFF
        return cnt, s

    def visits(self, data, state=0):
        """Per-state visit counts over a walk of ``data`` (the state
        BEFORE each byte is counted).  Returns (counts int64 [S],
        state_after).  Used to pick the hot-core state set
        (ops/pallas_core.py)."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        counts = np.zeros(self.dfa.nstates, dtype=np.int64)
        if self.lib is not None:
            st = np.array([state], dtype=np.int32)
            self.lib.sre_dfa_visits(
                _i32p(self.fused), _u8p(buf), len(buf), _i32p(st),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return counts, int(st[0])
        s = state
        fused = self.fused
        for b in buf:
            counts[s] += 1
            s = fused[s, b] & 0xFFFFF
        return counts, s

    def transfer(self, data):
        """Full transfer function of a chunk: (phi [S], fm [S])."""
        buf = np.frombuffer(data, dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        S = self.dfa.nstates
        phi = np.zeros(S, dtype=np.int32)
        fm = np.zeros(S, dtype=np.int64)
        if self.lib is not None:
            self.lib.sre_dfa_transfer(
                _i32p(self.fused), S, _u8p(buf), len(buf), _i32p(phi),
                fm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return phi, fm
        for s0 in range(S):
            r, s = self.scan_first(buf, s0)
            phi[s0] = s if r < 0 else self._run_all(buf, s0)
            fm[s0] = r
        return phi, fm

    def _run_all(self, buf, s0):
        s = s0
        fused = self.fused
        for b in buf:
            s = fused[s, b] & 0xFFFFF
        return s
