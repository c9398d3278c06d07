"""The port's spans (``fss_tpu_torch.utils.profiling``) joined to a traced
run's device trace: where the host's time goes by layer, and which device
work and idle each layer holds.

``join`` takes the ``Record`` of the measured closed loop, the trace's
events and its ``baseTimeNanoseconds`` (the file ``trace.Tracer`` wrote).
It puts the spans on the trace's clock as ``profile_trace`` does
(``Record.chrome_events``), and matches each launching runtime call (``cudaLaunchKernel`` and the like)
to its device work by ``correlation``. Host figures come from the same
requests ``dispatch_ms`` samples, those outside the profiler's window
``± harness.SETTLE_S``; device figures from the spans that lie wholly
inside the host's part of the trace (its first runtime call to its last).
A span's launches are the launching calls that start inside it; its
device time, that of the records they queued. ``lost`` counts launching
calls whose device record the trace lacks.
``METRICS`` names what the figures make, one value a metric.

Run as a script, it runs cells the way ``run.py`` does, in one process,
with the spans recorded over each measured loop: the harness's
``generator.closed_loop`` is wrapped for the call, and nothing else of the
harness changes.

    python3 port_bench/spans.py --workload dcf20.eval --seeds 1,2,3 \\
        --trace 1
    python3 port_bench/spans.py --workload dcf20.eval --seeds 1,2,3 \\
        --trace 0 --on-off
    python3 port_bench/spans.py --site-cost

One JSON line a run: with ``--trace 1`` the cell's per-layer metrics and
the spans' (``METRICS``), the device's idle split by the innermost span
open and the share of the port's launches inside their ``launch.<kernel>``
span; with ``--on-off`` each seed runs untraced with the spans off and on,
in turns, each line its end-to-end metrics beside ``dispatch_ms`` and the
spans' host means. ``--site-cost`` times a marked function against the
plain one, recording off and on. The benchmark's own runs never run it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import gzip
import json
import pathlib
import sys
import time

if __name__ == "__main__":  # run as a script: the package from the root
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "port_bench"]
    sys.path.insert(0, str(ROOT))

from port_bench import generator, harness, readers, trace  # noqa: E402

LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")
LAUNCHING = ("Launch", "Memcpy", "Memset")  # in a call's name: it queues
NO_SPAN = ""  # the idle split's key for no port span open

METRICS = {
    "api_ms.eval": lambda j: j.host_ms.get("api.Dcf.eval"),
    "api_ms.gen": lambda j: j.host_ms.get("api.Dcf.gen_batch"),
    "wrapper_ms.eval": lambda j: j.host_ms.get("ops.dcf.eval_packed"),
    "finalize_ms.eval": lambda j: j.host_ms.get("ops.dcf.finalize"),
    "finalize_launches.eval": lambda j: j.launched.get("ops.dcf.finalize"),
    "finalize_device_ms.eval": lambda j: j.device_ms.get("ops.dcf.finalize"),
    "idle_in_finalize.eval": lambda j: j.idle_in.get("ops.dcf.finalize"),
}


@dataclasses.dataclass
class Joined:
    host_ms: dict  # span name -> mean ms, the host-sampled requests
    launched: dict  # span name -> launching calls a span, started in it
    device_ms: dict  # span name -> device ms a span of those ops
    idle_in: dict  # span name -> % of the window idle, one open
    idle_innermost: dict  # innermost open span ("" none) -> % idle
    launch_inside: float | None  # % of the port's launches in their span
    window_s: float | None
    lost: int = 0  # launching calls in the trace with no device record


def _merged(rows) -> list:
    """Sorted, merged [start, end] intervals."""
    out = []
    for a, b in sorted(rows):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _stem(launch_span: str) -> str:
    """``launch.dcf_eval_aes`` -> ``dcf_eval``: the kernel's symbol stem."""
    key = launch_span[len("launch."):]
    return key[:-len("_aes")] if key.endswith("_aes") else key


def join(rec, events, base_ns: float, trace_span=None,
         settle_s: float = harness.SETTLE_S) -> Joined:
    """The spans of ``rec`` against the trace ``events`` (``ts`` in us after
    ``base_ns``); ``trace_span``: the profiler's (opened, closed), on
    ``time.monotonic``, or None when the run was not traced."""
    spans = rec.spans
    lo, hi = ((trace_span[0] - settle_s, trace_span[1] + settle_s)
              if trace_span else (0.0, 0.0))
    host = collections.defaultdict(list)
    for s in spans:
        if not lo <= s.start_ns * 1e-9 <= hi:
            host[s.name].append(s.end_ns - s.start_ns)
    host_ms = {k: sum(v) / len(v) * 1e-6 for k, v in host.items()}
    out = Joined(host_ms, {}, {}, {}, {}, None, None)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in trace.DEVICE_CATS]
    calls = [e for e in xs if e.get("cat") in LAUNCH_CALLS]
    if not dev or not calls:
        return out
    w0 = min(float(e["ts"]) for e in dev)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    c0 = min(float(e["ts"]) for e in calls)
    c1 = max(float(e["ts"]) + float(e["dur"]) for e in calls)
    out.window_s = (w1 - w0) * 1e-6

    # On the trace's clock as ``profile_trace`` writes them.
    mapped = [(s, e["ts"], e["ts"] + e["dur"])
              for s, e in zip(spans, rec.chrome_events(base_ns))]
    inside = [m for m in mapped if c0 <= m[1] and m[2] <= c1]

    # Each launching call, by its start, with the device ops it queued.
    ops = collections.defaultdict(list)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            ops[corr].append(e)
    launching = sorted(
        (float(c["ts"]), ops.get(c.get("args", {}).get("correlation"), []))
        for c in calls if any(k in c["name"] for k in LAUNCHING))
    out.lost = sum(not queued for _, queued in launching)
    starts = [t for t, _ in launching]
    by_name = collections.defaultdict(list)
    for s, a, b in inside:
        by_name[s.name].append((a, b))
    idle = []
    prev = w0
    for a, b in _merged([float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                        for e in dev):
        if a > prev:
            idle.append([prev, a])
        prev = max(prev, b)
    for name, rows in by_name.items():
        n = secs = 0
        for a, b in rows:
            for _, queued in launching[bisect.bisect_left(starts, a):
                                       bisect.bisect_right(starts, b)]:
                n += 1
                secs += sum(float(e["dur"]) for e in queued) * 1e-6
        out.launched[name] = n / len(rows)
        out.device_ms[name] = secs / len(rows) * 1e3
        clipped = _merged([max(a, w0), min(b, w1)] for a, b in rows
                          if b > w0 and a < w1)
        out.idle_in[name] = _overlap(idle, clipped) / (w1 - w0) * 100
    out.idle_innermost = _innermost_idle(mapped, idle, w0, w1)
    out.launch_inside = _launch_inside(inside, dev, calls)
    return out


def _innermost_idle(mapped, idle, w0, w1) -> dict:
    """% of the window [w0, w1] with the device idle, by the innermost
    span open then (the deepest; ``NO_SPAN`` when none is)."""
    depth = {}
    for s, _, _ in sorted(mapped, key=lambda m: m[1]):
        depth[s.id] = depth.get(s.parent, -1) + 1
    edges = []
    for s, a, b in mapped:
        if b > w0 and a < w1:
            edges.append((max(a, w0), 1, s))
            edges.append((min(b, w1), 0, s))
    for a, b in idle:
        edges.append((a, 2, None))
        edges.append((b, 2, None))
    edges.sort(key=lambda e: (e[0], e[1]))
    idle_starts = [a for a, _ in idle]
    open_, split = {}, collections.defaultdict(float)
    prev = w0
    for t, kind, s in edges:
        if t > prev:
            mid = (prev + t) / 2
            k = bisect.bisect_right(idle_starts, mid) - 1
            if k >= 0 and idle[k][0] <= mid <= idle[k][1]:
                top = max(open_.values(), default=None,
                          key=lambda v: depth[v.id])
                split[NO_SPAN if top is None else top.name] += t - prev
            prev = t
        if kind == 1:
            open_[s.id] = s
        elif kind == 0:
            open_.pop(s.id, None)
    return {k: v / (w1 - w0) * 100 for k, v in split.items()}


def _launch_inside(inside, dev, calls) -> float | None:
    """% of the port's kernels whose launching call lies wholly inside a
    ``launch.<kernel>`` span of that kernel."""
    ours = {e["args"]["correlation"]: e["name"] for e in dev
            if any(k in e["name"] for k in trace.PORT_KERNELS)
            and "correlation" in e.get("args", {})}
    launch = [(s.name, a, b) for s, a, b in inside
              if s.name.startswith("launch.")]
    hits = total = 0
    for c in calls:
        symbol = ours.get(c.get("args", {}).get("correlation"))
        if symbol is None:
            continue
        total += 1
        t0, t1 = float(c["ts"]), float(c["ts"]) + float(c["dur"])
        hits += any(a <= t0 and t1 <= b and f"{_stem(n)}_kernel" in symbol
                    for n, a, b in launch)
    return hits / total * 100 if total else None


def metrics(j: Joined) -> dict:
    """``METRICS`` that ``j`` holds a value for."""
    return {k: v for k, v in ((k, f(j)) for k, f in METRICS.items())
            if v is not None}


def read_trace(path) -> tuple:
    """(events, baseTimeNanoseconds) of the gzip'd Chrome trace that
    ``trace.Tracer`` wrote."""
    with gzip.open(path, "rt") as f:
        raw = json.load(f)
    return raw["traceEvents"], raw.get("baseTimeNanoseconds", 0)


# -- the script ---------------------------------------------------------------

@contextlib.contextmanager
def recorded(on: bool = True):
    """While open, the harness's measured loop (``seconds`` > 0) runs
    inside ``profiling.record()``; yields a dict that then holds the
    ``record``, the loop's ``window`` and its ``tracer`` (None untraced)."""
    from fss_tpu_torch.utils import profiling
    held, loop = {}, generator.closed_loop

    def measured(dispatch, mark, mix, seconds, schedule, keep=True,
                 tracer=None):
        if not (on and seconds):
            return loop(dispatch, mark, mix, seconds, schedule, keep=keep,
                        tracer=tracer)
        with profiling.record() as rec:
            w = loop(dispatch, mark, mix, seconds, schedule, keep=keep,
                     tracer=tracer)
        held.update(record=rec, window=w, tracer=tracer)
        return w

    generator.closed_loop = measured
    try:
        yield held
    finally:
        generator.closed_loop = loop


def run(workload: str, seed: int, seconds: float, trace_on: bool,
        spans_on: bool = True, device: str = "cuda", cfg=None,
        mix=None) -> dict:
    """One run of a cell, as ``harness.run``, with the spans recorded over
    the measured loop when ``spans_on``: its result line, and the spans'
    figures under ``spans``."""
    spec = harness.ROOT / "BENCHMARK.json"
    cell = harness.Cell.find(workload, spec, cfg, mix)
    job = dict(workload=workload, seed=seed, seconds=seconds,
               trace=trace_on, device=device, spec=str(spec), cfg=cfg,
               mix=mix)
    t0 = time.monotonic()
    with recorded(spans_on) as held:
        r = harness.serve(job)
    line = harness.result(cell, r, seconds, trace_on, t0, device)["line"]
    line.pop("breakdown", None)
    line["metrics"] = {k: v["value"] for k, v in line["metrics"].items()}
    line["metrics"]["dispatch_ms"] = readers.mean_ms(r["dispatch_s"])
    line.update(workload=workload, seed=seed, trace=trace_on,
                spans_on=spans_on)
    rec = held.get("record")
    if rec is None:
        return line
    events, base = [], 0
    if held["tracer"] is not None and held["window"].trace_span is not None:
        # The file this run's tracer closed and wrote.
        events, base = read_trace(held["tracer"].path)
    j = join(rec, events, base, held["window"].trace_span)
    line["spans"] = dict(
        metrics(j), kept=len(rec.spans), dropped=rec.dropped,
        host_ms=j.host_ms, launched=j.launched,
        device_ms=j.device_ms, idle_in=j.idle_in,
        idle_innermost=j.idle_innermost, launch_inside=j.launch_inside,
        window_s=j.window_s, lost=j.lost)
    return line


def site_cost(calls: int = 1_000_000) -> dict:
    """ns a call of a marked no-op beyond the plain one, recording off,
    and with a span kept, recording on; the best of five rounds each."""
    from fss_tpu_torch.utils import profiling

    def plain(x):
        return x

    marked = profiling.span("site")(plain)

    def best(fn, n):
        times = []
        for _ in range(5):
            t = time.perf_counter_ns()
            for _ in range(n):
                fn(1)
            times.append((time.perf_counter_ns() - t) / n)
        return min(times)

    base = best(plain, calls)
    off = best(marked, calls)
    with profiling.record():
        on = best(marked, calls // 10)
    return {"plain_ns": base, "off_extra_ns": off - base,
            "on_extra_ns": on - base, "calls": calls}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--on-off", action="store_true",
                    help="each seed untraced, spans off and on in turns")
    ap.add_argument("--site-cost", action="store_true")
    args = ap.parse_args(argv)
    if args.site_cost:
        print(json.dumps(site_cost()), flush=True)
    if not args.workload:
        return 0
    from fss_tpu_torch import _build
    _build.build()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        turns = ([True] if not args.on_off else
                 [i % 2 == 0, i % 2 == 1])
        for spans_on in turns:
            line = run(args.workload, seed, args.seconds,
                       bool(args.trace) and not args.on_off, spans_on)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
