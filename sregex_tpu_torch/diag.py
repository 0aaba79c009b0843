"""Scan observability: per-scan stats records, spans, and loud
degradation.

The reference's only introspection is the per-TU ``dd()`` trace macro
(ddebug.h:13-26).  A TPU framework deserves more: all the adaptive
policy lives in the device dispatch (tier selection, chunk
speculation, escape repair, re-coring), and a production operator
needs to see which path served a scan and how much of it had to be
repaired natively — silent degradation is indistinguishable from
normal operation otherwise.

Three facilities:

- ``ScanStats``: one record per completed high-level scan
  (Scanner.match/count/scan/*_stream), exposed via
  ``Scanner.stats()``.  Fields: the API called, the tier that served
  it, corpus bytes, kernel chunk count, natively repaired chunks,
  cumulative re-core events, wall-clock ms and, for find, whether
  the one-pass tagged result was certified.

- Spans: a flight recorder of where each call's host time goes, on
  by default (``set_recording(False)`` turns it off).  A span has a
  name, the query id that every span of one call shares, its parent
  span's id, start and end in ns and an optional integer value (bytes,
  say).  A public call opens the root span (``call``: sregex.count,
  sregex.scan, sregex.match, sregex.find, ...); inside it the device
  path marks consecutive phases (``phase``), each closed by the next
  or by the span that holds it, so a call's phases tile its time:

    sregex.tier      the tier choice (fused, core, phi, static)
    sregex.launch    prep lookup, entry planes, the kernel launches
    sregex.summary   the enqueue of the validation summary (one kernel
                     launch on the card, torch ops on the CPU)
    sregex.readback  the host blocked on a device-to-host copy (value:
                     bytes read back)
    sregex.fold      readback's return to the call's return

  and ``span`` nests work inside a phase: sregex.prep (value: corpus
  bytes) where a prep is built, never on a cache hit.  Spans go into
  a ring of the last RING_SPANS (``recent_spans``, in the order they
  ended); per-name totals of count, ns and value (``span_totals``)
  outlive the ring.  The clock is ``time.time_ns``, the one
  torch.profiler stamps its events with, and while a profiler runs
  each span is also a profiler range of its name (``_range``: the
  profiler's fast range, a host event of function scope, not a
  record_function user annotation), so a trace names host time by
  span.  No torch op, event or sync is made.

- ``degraded(key, msg)``: called where the scan API deliberately
  swallows a device failure and falls back to the host engines.
  Default: warn ONCE per key (RuntimeWarning) so a broken device
  stack is visible without spamming per-scan.  With
  ``SREGEX_STRICT_DEVICE=1`` it raises instead — production serving
  where host-rate fallback is an outage, not a convenience.
"""

import collections
import functools
import itertools
import os
import threading
import time
import warnings

import torch
import torch.autograd.profiler as _profiler


class ScanStats:
    """One completed scan's record (see module docstring)."""

    __slots__ = ("api", "tier", "nbytes", "chunks", "repaired",
                 "recore_events", "warm_events", "elapsed_ms",
                 "certified")

    def __init__(self, api, tier, nbytes, chunks=0, repaired=0,
                 recore_events=0, warm_events=0, elapsed_ms=0.0,
                 certified=None):
        self.api = api
        self.tier = tier
        self.nbytes = nbytes
        self.chunks = chunks
        self.repaired = repaired
        self.recore_events = recore_events
        self.warm_events = warm_events
        self.elapsed_ms = elapsed_ms
        self.certified = certified

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return ("ScanStats(" + ", ".join(
            f"{k}={getattr(self, k)!r}" for k in self.__slots__) + ")")


def strict_device():
    return os.environ.get("SREGEX_STRICT_DEVICE") == "1"


_warned = set()


def reset_warned():
    """Test hook: re-arm the warn-once latch."""
    _warned.clear()


def degraded(key, msg):
    """Record a silent-degradation event: the device path failed and
    the scan API is about to fall back to the host engines.  Warns
    once per ``key``; raises under SREGEX_STRICT_DEVICE=1."""
    if strict_device():
        raise RuntimeError(
            f"sregex-tpu device degradation (SREGEX_STRICT_DEVICE=1): "
            f"{msg}")
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"sregex-tpu: {msg} — falling back to the host engines "
        f"(set SREGEX_STRICT_DEVICE=1 to make this an error)",
        RuntimeWarning, stacklevel=3)


# -- spans ------------------------------------------------------------

RING_SPANS = 1 << 16

_recording = True
_ring = collections.deque(maxlen=RING_SPANS)
_totals = {}
_local = threading.local()
_ids = itertools.count(1)
_queries = itertools.count(1)
_now = time.time_ns
# a span's range while a profiler runs: the profiler's fast range, a
# function-scope event of the span's name (a few us; record_function's
# user annotation costs tens of us a range under the CUDA profiler)
_range = torch._C._profiler._RecordFunctionFast

SpanTotal = collections.namedtuple("SpanTotal", "count ns value")


class Span(collections.namedtuple(
        "Span", "name query id parent start_ns end_ns value")):
    """One recorded span (module docstring).  ``parent`` is the parent
    span's ``id``, None for a root."""

    __slots__ = ()

    @property
    def ns(self):
        return self.end_ns - self.start_ns


# an open span is a list [name, query, id, parent id, start ns, end ns,
# value, is a phase, its profiler range or None]; it is recorded as it
# ends.  The totals are updated without a lock: exact where one thread
# records at a time.  A profiler range is entered after its span's
# start is stamped and left before its end is, so each annotation lies
# inside its span, short of it by what entering and leaving cost.

def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _open(stack, name, value, is_phase, now):
    if stack:
        top = stack[-1]
        rec = [name, top[1], next(_ids), top[2], now, 0, value, is_phase,
               None]
    else:
        rec = [name, next(_queries), next(_ids), None, now, 0, value,
               is_phase, None]
    if _profiler._is_profiler_enabled:
        rec[8] = _range(name)
        rec[8].__enter__()
    stack.append(rec)
    return rec


def _leave(rec):
    if rec[8] is not None:
        rec[8].__exit__(None, None, None)
        rec[8] = None


def _record(rec, end):
    rec[5] = end
    _ring.append(rec)
    t = _totals.get(rec[0])
    if t is None:
        _totals[rec[0]] = [1, end - rec[4], rec[6]]
    else:
        t[0] += 1
        t[1] += end - rec[4]
        t[2] += rec[6]


def _close(stack, rec):
    """End ``rec`` and every span still open above it."""
    if rec[5]:
        return      # an enclosing span ended it
    ended = []
    while True:
        top = stack.pop()
        _leave(top)
        ended.append(top)
        if top is rec:
            break
    end = _now()
    for top in ended:
        _record(top, end)


class _SpanContext:
    __slots__ = ("name", "value", "stack", "rec")

    def __init__(self, name, value):
        self.name = name
        self.value = value

    def __enter__(self):
        stack = self.stack = _stack()
        self.rec = None
        if _recording and not (stack and stack[-1][0] == self.name):
            self.rec = _open(stack, self.name, self.value, False, _now())

    def __exit__(self, *exc):
        if self.rec is not None:
            _close(self.stack, self.rec)
        return False


def span(name, value=0):
    """A context manager that records a span of ``name`` (and
    ``value``), a child of the innermost open span, else a root.
    Inside an open span of the same name it records nothing: the work
    is that span's."""
    return _SpanContext(name, value)


def phase(name, value=0):
    """End the phase open at the top of this thread's spans, if any, and
    open the phase ``name`` in its place, a child of the innermost open
    span, from the same instant; it lasts until the next phase or until
    that span ends.  No change where the open phase has this name
    already; nothing is recorded outside an open span."""
    if not _recording:
        return
    try:
        stack = _local.stack
    except AttributeError:
        return      # no span was ever opened on this thread
    if not stack:
        return
    top = stack[-1]
    if top[7]:
        # a phase lies on the span that holds it: the stack stays open
        if top[0] == name:
            return
        stack.pop()
        _leave(top)
        now = _now()
        _record(top, now)
    else:
        now = _now()
    _open(stack, name, value, True, now)


def read_back(t):
    """``t.cpu()`` (a list of each one's, for a list or tuple of
    tensors) as a sregex.readback phase (value: the bytes read), the
    sregex.fold phase open after it."""
    many = isinstance(t, (list, tuple))
    ts = t if many else (t,)
    phase("sregex.readback", sum(x.numel() * x.element_size() for x in ts))
    out = [x.cpu() for x in ts]
    phase("sregex.fold")
    return out if many else out[0]


def call(name):
    """Decorator: each call of the function records the span ``name``,
    a root where no span is open (as ``span`` records it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _recording:
                return fn(*args, **kwargs)
            stack = _stack()
            if stack and stack[-1][0] == name:
                return fn(*args, **kwargs)
            rec = _open(stack, name, 0, False, _now())
            try:
                return fn(*args, **kwargs)
            finally:
                _close(stack, rec)
        return traced
    return wrap


def set_recording(on):
    """Turn the span recorder on (the default) or off.  Spans already
    open still end."""
    global _recording
    _recording = bool(on)


def recent_spans():
    """The ring's last RING_SPANS spans as Span tuples, in the order
    they ended."""
    return [Span(*r[:7]) for r in _ring.copy()]


def span_totals():
    """{name: SpanTotal(count, ns, value)} of every span recorded since
    the last clear_spans, evicted from the ring or not."""
    return {k: SpanTotal(*v) for k, v in list(_totals.items())}


def clear_spans():
    """Empty the ring and the totals."""
    _ring.clear()
    _totals.clear()
