"""The span recorder of sregex_tpu_torch.diag: the span tree of a call
on the device tiers (their plain torch versions on the CPU) and on the
host engine, the ring's bound and the totals past it, the switch, the
per-thread parents, and the profiler ranges under torch.profiler on the
recorder's clock."""

import threading

import numpy as np
import pytest
import torch

import sregex_tpu_torch
from sregex_tpu_torch import diag

torch.set_num_threads(1)

PATTERNS = ["agggtaaa|tttaccct", "[cgt]gggtaaa|tttaccc[acg]"]
SKEW_NS = 20_000
PHASES = ["sregex.tier", "sregex.launch", "sregex.summary",
          "sregex.readback", "sregex.fold"]


@pytest.fixture(scope="module")
def scanner():
    sc = sregex_tpu_torch.compile_pattern(PATTERNS, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    rng = np.random.default_rng(19)
    data = rng.choice(np.frombuffer(b"acgt", np.uint8), 1 << 16).tobytes()
    return sc, data


@pytest.fixture(autouse=True)
def _clean():
    diag.clear_spans()
    diag.set_recording(True)
    yield
    diag.set_recording(True)
    diag.clear_spans()


def _call(spans, name):
    """The last root ``name`` among ``spans`` and its spans, by start."""
    root = next(s for s in reversed(spans)
                if s.name == name and s.parent is None)
    kids = sorted((s for s in spans if s.query == root.query
                   and s.id != root.id), key=lambda s: (s.start_ns, s.id))
    return root, kids


@pytest.mark.parametrize("api", ["count", "scan"])
@pytest.mark.parametrize("prepared", [False, True], ids=["bytes", "handle"])
def test_device_call_records_the_span_tree(scanner, api, prepared):
    sc, data = scanner
    h = sc.prepare(data) if prepared else None
    getattr(sc, api)(data, prepared=h)
    root, kids = _call(diag.recent_spans(), "sregex." + api)
    phases = [s for s in kids if s.parent == root.id]
    assert [s.name for s in phases] == PHASES
    # the phases tile the call from the tier choice on
    assert root.start_ns <= phases[0].start_ns
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns == b.start_ns
    assert phases[-1].end_ns == root.end_ns
    assert phases[PHASES.index("sregex.readback")].value == 40
    # the prep is built once, inside the launch, with the corpus's bytes
    launch = phases[PHASES.index("sregex.launch")]
    preps = [s for s in kids if s.name == "sregex.prep"]
    assert len(preps) == 1 and preps[0].parent == launch.id
    assert preps[0].value == len(data)
    assert launch.start_ns <= preps[0].start_ns <= preps[0].end_ns \
        <= launch.end_ns
    assert {s.parent for s in kids} <= {root.id, launch.id}
    if prepared:
        # a second call over the handle finds its prep: none recorded
        diag.clear_spans()
        getattr(sc, api)(data, prepared=h)
        _, kids = _call(diag.recent_spans(), "sregex." + api)
        assert [s.name for s in kids] == PHASES


def test_host_path_records_its_root_only(scanner):
    sc, data = scanner
    small = data[:4096]
    assert sc.count(small) == sc._native.count(small, 0)[0] + (
        1 if sc._eof_id(sc._native.count(small, 0)[1]) >= 0 else 0)
    spans = diag.recent_spans()
    assert [(s.name, s.parent) for s in spans] == [("sregex.count", None)]


def test_calls_nest_under_the_outer_call(scanner):
    sc, data = scanner
    sc.count_many([data[:4096], data[4096:8192]])
    spans = diag.recent_spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["sregex.count_many"]
    assert {s.query for s in spans} == {roots[0].query}


def test_ring_is_bounded_and_totals_outlive_it():
    n = diag.RING_SPANS + 1000
    for i in range(n):
        with diag.span("t.outer", 3):
            diag.phase("t.phase")
    spans = diag.recent_spans()
    assert len(spans) == diag.RING_SPANS
    assert spans[-1].name == "t.outer" and spans[-2].name == "t.phase"
    tot = diag.span_totals()
    assert tot["t.outer"].count == tot["t.phase"].count == n
    assert tot["t.outer"].value == 3 * n and tot["t.phase"].value == 0
    assert tot["t.outer"].ns >= tot["t.phase"].ns > 0


def test_recording_off_records_nothing(scanner):
    sc, data = scanner
    diag.set_recording(False)
    sc.count(data, prepared=sc.prepare(data))
    with diag.span("t.off"):
        diag.phase("t.off.phase")
    assert diag.recent_spans() == [] and diag.span_totals() == {}
    diag.set_recording(True)
    sc.count(data)
    assert {s.name for s in diag.recent_spans()} >= set(PHASES)


def test_phases_outside_a_span_and_same_names():
    diag.phase("t.orphan")              # no open span: nothing
    with diag.span("t.a"):
        pass
    with diag.span("t.a"):
        with diag.span("t.a"):          # the same work: one span
            diag.phase("t.p")
            diag.phase("t.p")           # already open: no change
    names = [s.name for s in diag.recent_spans()]
    assert "t.orphan" not in names and names.count("t.p") == 1
    assert names.count("t.a") == 2


def test_parents_are_per_thread():
    seen = {}

    def worker():
        with diag.span("t.worker"):
            pass
        seen["done"] = True

    with diag.span("t.main"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    spans = {s.name: s for s in diag.recent_spans()}
    assert seen["done"]
    assert spans["t.worker"].parent is None
    assert spans["t.worker"].query != spans["t.main"].query


def test_spans_are_profiler_ranges_on_its_clock(scanner):
    sc, data = scanner
    h = sc.prepare(data)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # a profile's first range pays for the profiler's start
        sc.count(data, prepared=h)
        diag.clear_spans()
        sc.count(data, prepared=h)
    spans = diag.recent_spans()
    notes = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() != torch.autograd.DeviceType.CUDA
             and e.name().startswith("sregex.")]
    assert sorted(s.name for s in spans) == sorted(PHASES + ["sregex.count"])
    for s in spans:
        e = min((e for e in notes if e.name() == s.name),
                key=lambda e: abs(e.start_ns() - s.start_ns))
        assert abs(e.start_ns() - s.start_ns) < 100_000, s.name
        end = e.start_ns() + e.duration_ns()
        assert abs(end - s.end_ns) < 100_000, s.name
    # off the profiler no range is made
    assert not torch.autograd.profiler._is_profiler_enabled


def test_profiler_ranges_nest_in_their_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with diag.span("t.warm"):
            pass
        diag.clear_spans()
        with diag.span("t.outer"):
            diag.phase("t.one")
            diag.phase("t.two")
    spans = {s.name: s for s in diag.recent_spans()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("t.")}
    assert set(events) == {"t.warm"} | set(spans)
    for name, s in spans.items():
        e = events[name]
        # the profiler's fast range: a function-scope host event
        assert not e.is_user_annotation()
        # the range lies inside its span, entered after its start was
        # stamped and left before its end was (up to the profiler's
        # conversion of its own clock to this one)
        end = e.start_ns() + e.duration_ns()
        assert s.start_ns - SKEW_NS <= e.start_ns() < s.start_ns + 100_000
        assert s.end_ns - 100_000 < end <= s.end_ns + SKEW_NS
