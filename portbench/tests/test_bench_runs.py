"""Whole runs on the CPU at a small size, past the harness's look for a
card: a sound run is correct; a control or a fault in the timed path
is not; and nothing of JAX or the JAX package is loaded."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.control import control_system

SMALL = dict(device="cpu", shard_bytes=4 << 20, ring=2)
CELLS = ["redux.count.resident"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def program(cell, shards, device):
    return harness.program_system(cell, shards, device)


def stale(cell, shards, device):
    """A query that hands back the last query's answer."""
    sut = program(cell, shards, device)
    last = []

    def query(k):
        got = sut.query(k)
        out = last[0] if last else got
        last[:] = [got]
        return out
    return harness.System(query, sut.stats)


def half(cell, shards, device):
    """A query over half the shard, its count doubled."""
    sut = program(cell, shards, device)
    import sregex_tpu_torch
    sc = sregex_tpu_torch.compile_pattern(cell.config["patterns"],
                                          device=device)
    call = getattr(sc, cell.traffic["call"])

    def query(k):
        got = call(shards[k][:len(shards[k]) // 2])
        return 2 * got if cell.traffic["call"] == "count" else got
    return harness.System(query, sut.stats)


def altered(cell, shards, device):
    """A query whose answer is altered where it is produced."""
    sut = program(cell, shards, device)

    def query(k):
        got = sut.query(k)
        if cell.traffic["call"] == "count":
            return got + 1
        return None if got is None else (got[0], got[1] + 1)
    return harness.System(query, sut.stats)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, error = harness.run(workload, 2 ** 31 + 3, 2.0, 0,
                                        **SMALL)
    assert error is None and result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"scan_gbps", "query_ms_p95",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [stale, half, altered, control_system],
                         ids=["stale", "half", "altered", "control"])
def test_faults_and_control_are_not_correct(workload, fault):
    result, _ = harness.run(workload, 2 ** 31 + 4, 2.0, 0,
                                    system=fault, **SMALL)
    assert result["attempted"] >= 2
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_traced_run_reads_its_metrics():
    result, _ = harness.run("redux.count.resident", 2 ** 31 + 5, 1.5,
                                    1, **SMALL)
    assert result["correct"], result["checks"]
    # on the CPU no device operation is traced: only the host fold's
    # counter reads
    assert set(result["metrics"]) == {"repaired_chunk_share"}


DRY_RUN = """
import sys
sys.path.insert(0, %r)
from portbench import harness
result, _ = harness.run("redux.count.resident", 5, 0.3, 0, device="cpu",
                           shard_bytes=4 << 20, ring=2)
assert result["correct"], (result["checks"], result["notes"])
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_dry_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c",
                           DRY_RUN % str(harness.ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(proc.stdout.strip().splitlines()[-1].split(","))
    assert "sregex_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                           "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def other_tier(cell, shards, device):
    """The program, its counters reporting a tier other than the
    configuration's: right answers from another kernel."""
    sut = program(cell, shards, device)

    def stats():
        repaired, chunks, _ = sut.stats()
        return repaired, chunks, "SpecTablesBig"
    return harness.System(sut.query, stats, sut.machine)


def test_a_tier_other_than_the_configurations_is_not_correct():
    result, _ = harness.run("redux.count.resident", 2 ** 31 + 7, 1.5, 0,
                            system=other_tier, **SMALL)
    assert result["checks"]["wrong_answers"]["value"] == 0
    assert result["checks"]["departures"]["value"] > 0
    assert not result["correct"]
