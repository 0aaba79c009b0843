"""The span readers (spans.py and the metrics dispatch_ms, summary_ms,
readback_ms, fold_ms, prep_gbps) over a small traced CPU run: they read
the untraced window's queries, whose four ms split its mean latency,
once the trace holds an operation on a card; and read nothing where no
card ran or no program ran."""

import pytest
import torch

from portbench import harness
from portbench.control import control_system
from portbench.trace import Op

SMALL = dict(device="cpu", shard_bytes=4 << 20, ring=2)
SPLIT = ("dispatch_ms", "summary_ms", "readback_ms", "fold_ms")
SPANS = SPLIT + ("prep_gbps",)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def runs(monkeypatch):
    """Each Run that harness.run makes, kept for the test."""
    kept = []

    class Kept(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    return kept


def read(run, name):
    return harness.load_module(harness.HERE / "metrics" /
                               (name + ".py")).read(run)


def test_span_readers_split_the_untraced_latency(runs):
    result, error = harness.run("redux.count.resident", 2 ** 31 + 11, 1.0,
                                1, **SMALL)
    assert error is None and result["correct"], result["checks"]
    # no card ran on the CPU: the readers read nothing
    assert not set(SPANS) & set(result["metrics"])
    # the same run with the card's scan over its traced window, as a
    # card's trace holds it
    run = runs[0]
    lo, hi = run.trace.window
    run.trace.device_ops.append(Op("spec_scan_kernel", lo, hi))
    got = {k: read(run, k) for k in SPANS}
    assert all(v is not None and v > 0 for v in got.values()), got
    plain = run.plain_latency
    mean_ms = sum(plain) / len(plain) * 1e3
    split = sum(got[k] for k in SPLIT)
    assert abs(split - mean_ms) <= 0.1 * mean_ms, (got, mean_ms)


def test_span_readers_read_nothing_under_the_control():
    # the program's spans of earlier runs in this process stay in the
    # recorder: the readers must not take them for the control's
    harness.run("redux.count.resident", 2 ** 31 + 12, 0.5, 0, **SMALL)
    result, _ = harness.run("redux.count.resident", 2 ** 31 + 13, 0.5, 1,
                            system=control_system, **SMALL)
    assert not set(SPANS) & set(result["metrics"])
