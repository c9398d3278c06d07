"""Profiling: spans at the port's layer boundaries, and a trace of a block.

Counterpart of ``fss_tpu.utils.profiling``. Two tools:

  - ``span(name)`` marks a function as a layer boundary, and ``record()``
    keeps a span for every call of one, on the host's monotonic clock,
    while its block runs. Each span holds its name, its id, its parent's
    id (0 at the top), the request it belongs to, the thread and its
    start and end (``time.monotonic_ns``). A span opened while no span is
    open on its thread starts a new request, which its children share.
    While nothing records, a marked function reads one module global and
    calls through: no clock read, no span, no name formatted.
  - ``profile_trace`` records a ``torch.profiler`` trace of a block (CPU
    activity, and the card's kernels and copies on a CUDA device) and the
    block's spans, and writes both as one Chrome trace, which Perfetto and
    ``chrome://tracing`` open: the spans are ``"ph": "X"`` events of
    category ``port_span`` on the trace's own clock.

The spans' sites are the layers of the DCF and DPF paths: the API
(``api.Dcf.eval``, ``api.Dcf.gen_batch``, ``api.Dpf.eval``,
``api.Dpf.gen_batch``), the kernel wrappers (``ops.dcf.eval_shares``, the
DCF Eval's one launch on the card, ``ops.dcf.eval_packed``,
``ops.dcf.gen_packed``, ``ops.dpf.eval_packed``, ``ops.dpf.gen_packed``),
each launch (``launch.<kernel>``, the key of ``_build.launches``) and the
scheme glue (``ops.dcf.finalize``, ``ops.dpf.finalize``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import typing

import torch

CAPACITY = 1 << 20  # spans a record keeps; later ones are counted

# The record being filled, or None: the one global every site reads.
_active = None


class Span(typing.NamedTuple):
    name: str
    id: int
    parent: int  # 0: none open on the thread when it opened
    request: int
    thread: int  # the native thread id, as the profiler's ``tid``
    start_ns: int  # time.monotonic_ns()
    end_ns: int


class Record:
    """The spans kept while recording, and two anchors ``(time.time_ns(),
    time.monotonic_ns())``, taken when recording started and when it
    stopped, which map the spans' clock onto the wall clock. The first
    ``CAPACITY`` spans to open are kept; ``dropped`` counts the rest."""

    def __init__(self):
        self.dropped = 0
        self.anchors: list[tuple[int, int]] = []
        self._kept: list[tuple] = []  # Span fields, in the order they end
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._open = threading.local()  # (id, request, thread) innermost
        self._lock = threading.Lock()

    @property
    def spans(self) -> list[Span]:
        return [Span._make(s) for s in self._kept]

    def call(self, name: str, fn, args, kwargs):
        """``fn(*args, **kwargs)`` inside a span ``name``."""
        here = self._open
        outer = getattr(here, "top", None)
        sid = next(self._ids)
        if outer is None:
            # The thread's id once a thread: a system call (6.4 us on the
            # H100 machine's host, 40 ns for a clock read).
            thread = getattr(here, "thread", None)
            if thread is None:
                thread = here.thread = threading.get_native_id()
            parent, request = 0, next(self._requests)
        else:
            parent, request, thread = outer
        here.top = (sid, request, thread)
        start = time.monotonic_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            end = time.monotonic_ns()
            here.top = outer
            if sid <= CAPACITY:
                self._kept.append((name, sid, parent, request, thread, start,
                                   end))
            else:
                with self._lock:
                    self.dropped += 1

    def wall_ns(self, mono_ns: int) -> int:
        """A ``time.monotonic_ns`` reading on the wall clock
        (``time.time_ns``): the offset between the clocks, interpolated
        between the anchors (in integers: a double near 2^60 ns steps by
        256 ns)."""
        (w0, m0), (w1, m1) = self.anchors[0], self.anchors[-1]
        off0, off1 = w0 - m0, w1 - m1
        if m1 == m0:
            return mono_ns + off0
        return mono_ns + off0 + (off1 - off0) * (mono_ns - m0) // (m1 - m0)

    def chrome_events(self, base_ns: int) -> list[dict]:
        """The spans as Chrome trace events on a trace's clock: ``ts`` in
        us after ``base_ns`` (a Kineto trace's ``baseTimeNanoseconds``)."""
        pid = os.getpid()
        return [{"ph": "X", "cat": "port_span", "name": s.name, "pid": pid,
                 "tid": s.thread,
                 "ts": (self.wall_ns(s.start_ns) - base_ns) / 1e3,
                 "dur": (s.end_ns - s.start_ns) / 1e3,
                 "args": {"id": s.id, "parent": s.parent,
                          "request": s.request}}
                for s in self.spans]


def span(name):
    """Decorate a layer boundary: each call is a span ``name`` while a
    ``record()`` is open. ``name`` is a string, or a function of the call's
    arguments that returns one (called only while recording)."""
    def decorate(fn):
        @functools.wraps(fn)
        def site(*args, **kwargs):
            rec = _active
            if rec is None:
                return fn(*args, **kwargs)
            return rec.call(name(*args, **kwargs) if callable(name) else name,
                            fn, args, kwargs)
        return site
    return decorate


@contextlib.contextmanager
def record():
    """Keep the spans of the block, on every thread; yields the
    ``Record``:

        with record() as rec:
            dcf.eval(0, s0, cws, xs)
        rec.spans  # [Span(name="api.Dcf.eval", ...), ...]

    One record at a time: a second raises RuntimeError."""
    global _active
    if _active is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Record()
    rec.anchors.append((time.time_ns(), time.monotonic_ns()))
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec.anchors.append((time.time_ns(), time.monotonic_ns()))


@contextlib.contextmanager
def profile_trace(log_dir, device="cuda"):
    """Trace the block and write ``log_dir/trace.<pid>.<ns>.json``:

        with profile_trace("build/trace"):
            run_step()

    On a CUDA device the trace holds the card's activity too (each
    kernel under its symbol); the block's work is synchronised before
    the trace stops. The CPU alone is traced only when ``device`` is the
    CPU. The block's spans are recorded (``record()``, so not inside
    another) and written into the trace, category ``port_span``. Yields
    ``log_dir``.
    """
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_trace: no CUDA device")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    os.makedirs(log_dir, exist_ok=True)
    with record() as rec:
        with torch.profiler.profile(activities=activities) as prof:
            yield log_dir
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(
        rec.chrome_events(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
