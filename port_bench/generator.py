"""The general traffic generator: a mix's data file in, requests out.

A mix (``traffic/<name>.json``) holds only parameters:

  - ``op``: what a request asks of the configuration's system ("eval",
    "gen"; the system module maps it to a call of the port);
  - ``outstanding``: requests in flight at once, a closed loop (a client
    sends its next request when one completes);
  - ``pool``: distinct input sets made at set-up; request i takes set
    ``order[i % pool]``, a permutation drawn from the seed;
  - ``batch_log2``: keys (or points) a request, where the op has a batch;
  - ``sample``: requests, drawn from the seed among the first
    ``sample_from``, whose outputs are kept for the check; the last
    request to complete is kept as well.

Set-up runs ``WARM_ROUNDS`` rounds of ``outstanding`` requests through the
same loop, so that every buffer of the window exists before it. The traced
run's profiler opens ``TRACE_LEAD_S`` into the measured window and stays
open ``TRACE_SECONDS``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import time

import numpy as np

FIELDS = ("op", "outstanding", "pool", "batch_log2", "sample",
          "sample_from")
WARM_ROUNDS = 3
TRACE_LEAD_S = 1.0
TRACE_SECONDS = 1.0


@dataclasses.dataclass(frozen=True)
class Mix:
    op: str
    outstanding: int
    pool: int
    batch_log2: int | None
    sample: int
    sample_from: int

    @classmethod
    def load(cls, path, **overrides) -> "Mix":
        raw = json.loads(pathlib.Path(path).read_text())
        raw.update(overrides)
        unknown = set(raw) - set(FIELDS)
        if unknown:
            raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
        raw.setdefault("batch_log2", None)
        return cls(**raw)

    @property
    def batch(self) -> int:
        return 1 if self.batch_log2 is None else 1 << self.batch_log2


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the seed decides about the requests: the order in which they
    take the pool's input sets, and which outputs are kept."""

    order: tuple
    keep: frozenset

    @classmethod
    def draw(cls, mix: Mix, seed: int) -> "Schedule":
        rng = np.random.default_rng([seed, 0x7AFF1C])
        order = tuple(int(j) for j in rng.permutation(mix.pool))
        keep = rng.choice(mix.sample_from, size=min(mix.sample,
                                                    mix.sample_from),
                          replace=False)
        return cls(order, frozenset(int(i) for i in keep))

    def input_set(self, i: int) -> int:
        return self.order[i % len(self.order)]


@dataclasses.dataclass
class Window:
    """A closed loop's record: what was dispatched and completed, when."""

    start: float = 0.0
    end: float = 0.0
    dispatched: int = 0
    completed: int = 0  # completed by the window's end
    latencies: list = dataclasses.field(default_factory=list)  # (t, s)
    dispatch_s: list = dataclasses.field(default_factory=list)  # (t, s)
    kept: dict = dataclasses.field(default_factory=dict)
    last: tuple | None = None  # (request, output) of the last to complete
    trace_span: tuple | None = None  # the profiler's, opening to closed


def closed_loop(dispatch, done_marker, mix: Mix, seconds: float,
                schedule: Schedule, keep: bool = True,
                tracer=None) -> Window:
    """Run requests 0, 1, ... with ``mix.outstanding`` in flight until
    ``seconds`` have passed, then wait for those in flight.

    ``dispatch(i)`` issues request i and returns its output (which may
    still be computing); ``done_marker()`` returns an object whose
    ``synchronize()`` returns once everything issued before it is done.
    ``tracer``, if given, is opened ``TRACE_LEAD_S`` into the window and
    closed ``TRACE_SECONDS`` later (``open()``, ``close()``)."""
    w = Window()
    inflight = collections.deque()
    w.start = time.monotonic()
    deadline = w.start + seconds
    i, stop, tracing = 0, False, None
    while True:
        while not stop and len(inflight) < mix.outstanding:
            t = time.monotonic()
            out = dispatch(i)
            marker = done_marker()
            w.dispatch_s.append((t, time.monotonic() - t))
            inflight.append((i, t, marker, out))
            i += 1
        if not inflight:
            break
        j, t, marker, out = inflight.popleft()
        marker.synchronize()
        now = time.monotonic()
        if now <= deadline:
            w.completed += 1
        w.latencies.append((t, now - t))
        if keep and j in schedule.keep:
            w.kept[j] = out
        w.last = (j, out)
        if tracer is not None:
            if tracing is None and now >= w.start + TRACE_LEAD_S:
                opened = time.monotonic()
                tracer.open()  # the profiler's start may take a second
                tracing = time.monotonic()
            elif (tracing is not None and w.trace_span is None
                  and now >= tracing + TRACE_SECONDS):
                tracer.close()
                w.trace_span = (opened, time.monotonic())
        stop = stop or now >= deadline
    if tracer is not None and tracing is not None and w.trace_span is None:
        tracer.close()
        w.trace_span = (opened, time.monotonic())
    w.end = deadline
    w.dispatched = i
    return w


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100) of ``values``, nearest rank; None when
    empty."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
    return ordered[rank - 1]
