"""The port's multi-process layer: parallel.distributed (the
torch.distributed bootstrap, the process's mesh and corpus slice, the
four cases of tests/test_distributed.py) and parallel.multihost (count
and first-match scan of a corpus each process holds one slice of).

The two-process test spawns this file twice as a script (its
``__main__`` below): two gloo processes joined through a file in the
test's tmp_path, each on a 2-shard virtual CPU mesh, over an aligned
split (host_slices) and a ragged first slice.  Counts, boundaries,
states and regex ids must equal the native engine's over the whole
corpus and one process's scan of it: exact equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sregex_tpu_torch import compile_pattern  # noqa: E402
from sregex_tpu_torch.native import NativeDfa  # noqa: E402
from sregex_tpu_torch.ops.mesh import make_mesh  # noqa: E402
from sregex_tpu_torch.ops.spec_scan import (SpecTables,  # noqa: E402
                                            spec_count_bytes,
                                            spec_scan_bytes)
from sregex_tpu_torch.parallel import distributed as dist  # noqa: E402
from sregex_tpu_torch.parallel import multihost  # noqa: E402

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 64
ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


# ---------------------------------------------------------------------
# distributed (tests/test_distributed.py's cases)
# ---------------------------------------------------------------------

def test_initialize_single_process_noop(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    dist.initialize()          # no coordinator: nothing to join
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    dist.initialize()          # one process: nothing to join either
    assert not tdist.is_initialized()
    assert (dist.process_index(), dist.process_count()) == (0, 1)


def test_global_mesh_covers_devices():
    assert dist.global_mesh(devices=[CPU] * 3).size == 3
    if torch.cuda.is_available():
        assert dist.global_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.global_mesh()


def test_host_slice_partition():
    # one process: the slice is everything
    assert dist.host_slice(1000, chunk=64) == (0, 1000)
    # the chunk rounding never loses bytes
    assert dist.host_slice(127, chunk=64) == (0, 127)


def test_host_slice_multiproc_math(monkeypatch):
    """host_slice as each of 8 processes would compute it: contiguous,
    whole chunks but the last, covering the corpus."""
    n, chunk, nproc = 1 << 20, 2048, 8
    monkeypatch.setattr(dist, "process_count", lambda: nproc)
    spans = []
    for p in range(nproc):
        monkeypatch.setattr(dist, "process_index", lambda p=p: p)
        spans.append(dist.host_slice(n, chunk))
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c and (b - a) % chunk == 0


# ---------------------------------------------------------------------
# multihost
# ---------------------------------------------------------------------

def _tables(pattern):
    sc = compile_pattern(pattern, device=None)
    return SpecTables(sc.dfa, CPU)


def _corpus(n, alphabet, seed, plants=()):
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(alphabet, np.uint8), n)
    for at, word in plants:
        data[at:at + len(word)] = np.frombuffer(word, np.uint8)
    return data.tobytes()


def _cases(ndev):
    """(name, tables, corpus, slices of two processes): an aligned split
    whose chains all validate (summaries only), one with a ragged global
    tail, and a ragged first slice with a match in each half; the
    headline's machine, and a two-pattern set for the regex id."""
    bb = multihost.block_bytes(K)
    head = _tables("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    multi = _tables([b"zzz", b"needle"])
    n1 = 4 * bb
    d1 = _corpus(n1, b"abx x", 1, [(3 * bb + 99, b"needle")])
    n2 = 3 * bb + 137
    d2 = _corpus(n2, b"abx x", 2, [(bb + 777, b"baaaacca"),
                                   (2 * bb + 5, b"baaaacca")])
    cut = 2 * bb + 31337
    return [
        ("aligned", multi, d1, multihost.host_slices(n1, 2, K, ndev)),
        ("aligned-tail", head, d2, multihost.host_slices(n2, 2, K, ndev)),
        ("ragged", head, d2, [(0, cut), (cut, n2)]),
    ]


def _expect(tables, data):
    """The native engine's and one process's (count, scan) of ``data``."""
    nat = NativeDfa(tables.dfa)
    k, kst = nat.count(data, 0)
    f, rid, fst = nat.scan_first_id(data, 0)
    one = (spec_count_bytes(tables, data, K), spec_scan_bytes(tables, data, K))
    return ((kst, k), (fst, f, rid)), one


def run_cases(pid, mesh):
    """Every case's count and scan from this process's slice (the whole
    corpus without a process group), checked; returns the plane gathers
    each case needed."""
    gathers = []
    orig = multihost._planes

    def counted(mh):
        gathers[-1] += 1
        return orig(mh)

    multihost._planes = counted
    try:
        for name, tables, data, slices in _cases(2 * mesh.size):
            lo, hi = slices[pid] if tdist.is_initialized() \
                else (0, len(data))
            gathers.append(0)
            got = (multihost.count_multihost(tables, data[lo:hi], mesh, K,
                                             len(data)),
                   multihost.scan_multihost(tables, data[lo:hi], mesh, K,
                                            len(data)))
            native, one = _expect(tables, data)
            assert got == native, (name, pid, got, native)
            assert (got[0], got[1][:2]) == one, (name, pid, got, one)
            assert got[1][1] >= 0, name
    finally:
        multihost._planes = orig
    return gathers


def test_multihost_in_one_process():
    """With no process group the multi-process scan is one process's
    scan over its mesh."""
    run_cases(0, make_mesh([CPU] * 2))


def test_two_processes_over_gloo(tmp_path):
    """Two gloo processes, a 2-shard CPU mesh each: aligned and ragged
    slices equal the native engine and one process's scan; the aligned
    count, whose chains all validate, gathers no planes."""
    init = tmp_path / "pg"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), str(init)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIHOST_OK" in out, \
            "process %d:\n%s" % (pid, out[-3000:])
        # aligned: the count on summaries alone, the scan's match on the
        # planes; the ragged tail and the ragged split: both on planes
        assert "gathers [1, 2, 2]" in out, out[-3000:]


if __name__ == "__main__":
    rank, init = int(sys.argv[1]), sys.argv[2]
    dist.initialize("file://" + init, num_processes=2, process_id=rank)
    assert dist.process_count() == 2 and dist.process_index() == rank
    print("gathers", run_cases(rank, make_mesh([CPU] * 2)), flush=True)
    tdist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)
