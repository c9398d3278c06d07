"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything about a cell is found by name from its entry:

  - ``configs/<config>.json``: the configuration as it runs; its
    ``system`` names ``systems/<system>.py``, the module that drives the
    port for it and holds its check against the reference;
  - ``traffic/<traffic>.json``: the mix, read by ``generator.Mix``;
  - ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning
    the value, or None when it finds nothing to read.

A cell runs in this process, on one device.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import torch

from port_bench import generator, trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fss_tpu")
SETTLE_S = 0.5  # around the profiler's window, no host samples count


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: generator.Mix
    end_to_end: list  # the spec's entries this cell reports
    per_layer: list

    @classmethod
    def find(cls, workload: str, spec_path=ROOT / "BENCHMARK.json",
             cfg_overrides=None, mix_overrides=None) -> "Cell":
        spec = json.loads(pathlib.Path(spec_path).read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in {spec_path}")
        w = cells[workload]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        cfg = json.loads((ROOT / conf["file"]).read_text())
        cfg.update(cfg_overrides or {})
        mix = generator.Mix.load(HERE / "traffic" / f"{w['traffic']}.json",
                                 **(mix_overrides or {}))
        e2e = [m for m in spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        names = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in names]
        return cls(workload, w["chips"], cfg, mix, e2e, layer)

    def system(self):
        return load_module(HERE / "systems" / f"{self.cfg['system']}.py",
                           f"port_bench_system_{self.cfg['system']}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       f"port_bench_metric_{metric.replace('.', '_')}").read


@dataclasses.dataclass
class Ctx:
    """What the readers read."""

    cfg: dict
    mix: generator.Mix
    items: int
    seconds: float
    setup_s: float
    completed: int
    dispatched: int
    latencies: list  # seconds, requests the host samples count
    dispatch_s: list
    launches: dict  # the port's launches in the window, by kernel
    summary: trace.Summary | None  # of the traced run


class _Marker:
    """A CPU stand-in for a CUDA event: CPU work is done when issued."""

    def synchronize(self) -> None:
        return None


def _marker(device):
    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event()
            ev.record()
            return ev
        return mark
    return _Marker


def _forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _launch_counts():
    from fss_tpu_torch import _build
    return dict(_build.launches)


def serve(job: dict) -> dict:
    """Set-up, the window, the check. Returns the run's record."""
    cell = Cell.find(job["workload"], job["spec"], job.get("cfg"),
                     job.get("mix"))
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mix = cell.mix
    phases = {"enter": time.monotonic()}
    schedule = generator.Schedule.draw(mix, job["seed"])
    system = cell.system().System(cell.cfg, mix, job["seed"], device)
    phases["inputs"] = time.monotonic()
    system.start(schedule)
    phases["start"] = time.monotonic()
    mark = _marker(device)
    for _ in range(generator.WARM_ROUNDS):
        generator.closed_loop(system.dispatch, mark, mix, 0.0, schedule,
                              keep=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases["warm"] = time.monotonic()
    tracer = None
    if job["trace"]:
        tracer = trace.Tracer(ROOT / "build" / "port_bench" / "traces" /
                              f"{cell.name}.json.gz", device)
        tracer.warm()
    before = _launch_counts()
    w = generator.closed_loop(system.dispatch, mark, mix, job["seconds"],
                              schedule, tracer=tracer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v - before.get(k, 0) for k, v in _launch_counts().items()
                if v - before.get(k, 0)}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = None
    if tracer is not None and w.trace_span is not None:
        summary = trace.summarize(tracer.export())
    # Host samples: the requests dispatched outside the profiler's
    # window and its closing (the profiler slows the host's dispatch).
    lo, hi = ((w.trace_span[0] - SETTLE_S, w.trace_span[1] + SETTLE_S)
              if w.trace_span else (0.0, 0.0))

    def host(samples):
        return [s for t, s in samples if not lo <= t <= hi]
    outputs = {}
    for i, out in sorted(w.kept.items()) + [w.last]:
        outputs.setdefault(schedule.input_set(i), []).append(out)
    system.stop()
    w.kept, w.last = {}, None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    numbers, failed = system.check(outputs)
    return dict(
        start=w.start, completed=w.completed, dispatched=w.dispatched,
        items=system.items, launches=launches, expected=system.launched,
        peak=peak, summary=summary, latencies=host(w.latencies),
        dispatch_s=host(w.dispatch_s), numbers=numbers, failed=failed,
        check_s=time.monotonic() - t_check, phases=phases)


def run(workload: str, seed: int, seconds: float, trace_on: bool,
        t0: float, device: str = "cuda", spec=ROOT / "BENCHMARK.json",
        cfg=None, mix=None, marks=None) -> dict:
    """Run a cell once; the result line's object. ``t0``: the process's
    start (``time.monotonic``); ``marks``: set-up's moments before this
    call, by name."""
    cell = Cell.find(workload, spec, cfg, mix)
    if cell.chips != 1:
        raise SystemExit(f"{workload}: the harness runs one-chip cells")
    job = dict(workload=workload, seed=seed, seconds=seconds,
               trace=trace_on, device=device, spec=str(spec), cfg=cfg,
               mix=mix)
    if device == "cuda":
        from fss_tpu_torch import _build
        _build.build()
    marks = dict(marks or {}, built=time.monotonic())
    return result(cell, serve(job), seconds, trace_on, t0, device, marks)


def result(cell: Cell, r: dict, seconds: float, trace_on: bool,
           t0: float, device: str, marks=None) -> dict:
    summary = r["summary"]
    ctx = Ctx(cfg=cell.cfg, mix=cell.mix, items=r["items"],
              seconds=seconds, setup_s=r["start"] - t0,
              completed=r["completed"], dispatched=r["dispatched"],
              latencies=r["latencies"], dispatch_s=r["dispatch_s"],
              launches=r["launches"], summary=summary)
    numbers = r["numbers"]
    missing = [k for k in r["expected"] if not r["launches"].get(k)]
    correct = (not missing and r["failed"] == 0
               and all(v <= lim for v, lim, _ in numbers.values()))
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": r["peak"]}
    out = {"correct": correct, "attempted": r["dispatched"],
           "failed": r["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim, _) in numbers.items()}
    out["checks"]["kernels_not_launched"] = {"value": len(missing),
                                             "limit": 0}
    # Set-up's parts, seconds from the process's start: torch imported,
    # the card found, the port's libraries loaded; the run entered, its
    # inputs made, the program started (Eval's keys made), the warm
    # rounds done.
    moments = dict(marks or {}, **r["phases"])
    notes = {"setup": {k: round(v - t0, 3) for k, v in moments.items()},
             "missing": missing,
             "what": {k: what for k, (_, _, what) in numbers.items()},
             "check_s": r["check_s"]}
    return {"line": out, "notes": notes}
