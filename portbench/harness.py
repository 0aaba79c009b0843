"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

A cell (an entry of BENCHMARK.json's ``workloads``) names a
configuration (configs/<config>.json, with its plain reference
configs/<config>.py) and a traffic mix (traffic/<traffic>.json).  Set-up
builds the system under test, makes the traffic's ring of shards from
the seed with the configuration's generator (gen/<generator>.py) and
warms every shard.  The window is a closed loop of one client: each
query is one call over the next shard of the ring, issued when the last
has returned, for ``seconds``.  After it, every query over the
traffic's ``judged`` ring slots (drawn from the seed; all by default)
is judged against the plain reference.  Each metric is read by its own
reader, metrics/<metric>.py, from the run."""

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import reference, trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sregex_tpu")
WARM_LAPS = 2       # laps of the ring before the window
# a traced run's window: its profile costs ~10 s of post-processing a
# traced second
TRACE_SECONDS = 3


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """The Python file ``path`` as a module of its own (file names here
    are metric and configuration names, which may hold dots)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of BENCHMARK.json with what it names, loaded."""
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name, bench=None):
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / (w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return Cell(w, config, traffic, e2e, layer)


@dataclass
class System:
    """What the window drives: ``query(k)`` answers over shard k;
    ``stats()`` the program's counters of the last query; ``machine``
    its automaton's states and classes."""
    query: object
    stats: object = None
    machine: dict = None


def program_system(cell, shards, device):
    """sregex_tpu_torch's Scanner over the configuration's patterns
    (pattern i = entry i), over the shards, each prepared on the device
    once (Scanner.prepare) and passed back with ``prepared=``."""
    import sregex_tpu_torch
    sc = sregex_tpu_torch.compile_pattern(cell.config["patterns"],
                                          device=device)
    handles = [sc.prepare(s) for s in shards]
    call = getattr(sc, cell.traffic["call"])

    def query(k):
        return call(shards[k], prepared=handles[k])

    def stats():
        st = sc.stats()
        return None if st is None else (st.repaired, st.chunks, st.tier)

    machine = {"states": sc.dfa.nstates, "classes": sc.dfa.nclasses}
    return System(query, stats, machine)


@dataclass
class Run:
    """What one run leaves for the metric readers."""
    cell: Cell
    shard_bytes: int
    setup_s: float
    window_s: float = 0.0
    shards: list = field(default_factory=list)    # shard index of a query
    latency: list = field(default_factory=list)   # seconds of a query
    stats: list = field(default_factory=list)     # stats() after a query
    trace: object = None
    # a traced run's untraced window just before the traced one: the
    # latency of each of its queries (the profiler's cost left out)
    plain_latency: list = field(default_factory=list)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_probe():
    """Milliseconds of a fixed piece of interpreter work on this thread's
    core, the least of five: the host's speed at Python, which a query's
    glue runs at."""
    best = None
    for _ in range(5):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200000):
            acc += i * i & 7
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def _window(system, ring, seconds, traced, pin):
    """The closed loop; returns (ring slots, answers, latencies, stats,
    window seconds, the first traceback of a query that raised, the
    host probe's milliseconds before and after the window)."""
    slots, answers, lat, stats = [], [], [], []
    error = None
    query, read_stats = system.query, system.stats if traced else None
    # on the card's host the client's thread stays on one core (the
    # last this process may use) for the window, so the scheduler does
    # not move it between cores while it is timed
    allowed = os.sched_getaffinity(0)
    if pin:
        os.sched_setaffinity(0, {max(allowed)})
    probe = _host_probe()
    try:
        k = 0
        t_open = time.perf_counter()
        deadline = t_open + seconds
        t1 = t_open
        while t1 < deadline:
            t0 = time.perf_counter()
            try:
                got = query(k)
            except Exception:
                got = reference.FAILED
                error = error or traceback.format_exc()
            t1 = time.perf_counter()
            slots.append(k)
            answers.append(got)
            lat.append(t1 - t0)
            if read_stats is not None:
                stats.append(read_stats())
            k = (k + 1) % ring
    finally:
        host = {"probe_ms": [probe, _host_probe()]}
        os.sched_setaffinity(0, allowed)
    return slots, answers, lat, stats, t1 - t_open, error, host


def departures(sut, config):
    """How the system departs from what the configuration states: the
    tier that served its last query, the machine it compiled."""
    out = []
    served = sut.stats() if sut.stats is not None else None
    if served is not None and served[2] != config["tier"]:
        out.append("tier %s served, %s stated" % (served[2], config["tier"]))
    if sut.machine is not None and sut.machine != config["machine"]:
        out.append("machine %r, %r stated" % (sut.machine,
                                              config["machine"]))
    return out


def judged_slots(ring, count, seed):
    """The ring slots whose queries are judged: ``count`` of them (all
    where it is None or not less than the ring), drawn from the seed."""
    if count is None or count >= ring:
        return list(range(ring))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 9]))
    return sorted(int(k) for k in rng.choice(ring, count, replace=False))


def run(workload, seed, seconds, trace, *, device="cuda", t_start=None,
        shard_bytes=None, ring=None, system=None, bench=None):
    """One run of ``workload``.  Returns (the result line's object, the
    first traceback of a query that raised or None).
    ``system(cell, shards, device)`` puts another System in the
    program's place (a control, or a fault in the tests); ``shard_bytes``
    and ``ring`` shrink a run, and ``bench`` stands for BENCHMARK.json,
    for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, bench)
    config, traffic = cell.config, cell.traffic
    nbytes = shard_bytes or config["shard_bytes"]
    ring = ring or traffic["ring"]
    on_card = torch.device(device).type == "cuda"
    ref = load_module(HERE / "configs" / (config["name"] + ".py"))
    gen = load_module(HERE / "gen" / (config["generator"] + ".py"))
    card = _power_limit() if on_card else None

    timing = {"start_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    shards = gen.make_ring(config["params"], nbytes, ring, seed)
    timing["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if system is None:
        sut = program_system(cell, shards, device)
    else:
        sut = system(cell, shards, device)
    timing["system_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(WARM_LAPS):
        for k in range(ring):
            sut.query(k)
    _sync(device)
    timing["warm_s"] = time.perf_counter() - t0
    notes = departures(sut, config)
    gc.collect()
    gc.freeze()

    plain = []
    if trace:
        # the same loop untraced first, for the readers that set a
        # query's untraced time against the trace's device time
        plain = _window(sut, ring, TRACE_SECONDS, False, on_card)[2]
        _sync(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    slots, got, lat, stats, window_s, error, host = _window(
        sut, ring, min(seconds, TRACE_SECONDS) if trace else seconds,
        bool(trace), on_card)
    _sync(device)
    if trace:
        prof.__exit__(None, None, None)
    notes += departures(sut, config)
    peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    del sut
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program's state
    # is freed: the answer of each judged shard, and every query over
    # one judged against it
    call = traffic["call"]
    t0 = time.perf_counter()
    judged = judged_slots(ring, traffic.get("judged"), seed)
    want = {k: reference.answers(ref, shards[k], device) for k in judged}
    wrong = gap = checked = 0
    for k, g in zip(slots, got):
        if k in want:
            w, d = reference.judge(call, g, want[k], nbytes)
            wrong += w
            gap = max(gap, d)
            checked += 1
    checks = {"wrong_answers": {"value": wrong, "limit": 0},
              "max_gap": {"value": gap, "limit": 0},
              "departures": {"value": len(notes), "limit": 0}}
    correct = checked > 0 and wrong == 0 and gap == 0 and not notes
    timing["reference_s"] = time.perf_counter() - t0
    timing["judged"] = {"slots": judged, "queries": checked}

    r = Run(cell, nbytes, setup_s, window_s, slots, lat, stats,
            plain_latency=plain)
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(slots),
              "failed": wrong, "metrics": {}, "device": dev}
    t0 = time.perf_counter()
    if trace:
        r.trace = tracing.collect(prof)
        del prof
        if r.trace.device_ops:
            lo, hi = r.trace.window
            dev["busy_s"] = r.trace.busy_seconds()
            dev["window_s"] = (hi - lo) / 1e6
            result["breakdown"] = tracing.breakdown(r.trace)
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module(HERE / "metrics" / (m["name"] + ".py")).read(r)
        if value is not None:
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}
    timing["readers_s"] = time.perf_counter() - t0
    ordered = sorted(r.latency)
    timing["latency_ms"] = {
        q: ordered[min(len(ordered) - 1, int(f * len(ordered)))] * 1e3
        for q, f in (("p50", 0.5), ("p99", 0.99), ("max", 1.0))
    } if ordered else None
    result["card"] = card
    result["host"] = host
    result["timing"] = timing
    result["notes"] = notes
    result["checks"] = checks
    return result, error


def forbidden_modules():
    """The modules loaded whose top-level name is that of JAX, its
    relatives or the JAX package."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
