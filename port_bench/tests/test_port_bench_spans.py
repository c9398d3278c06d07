"""``spans.join`` on a synthetic trace and synthetic spans gives exact
launch counts, device ms and idle shares; ``spans.run`` records the spans
over a tiny cell's measured loop on the CPU and leaves the harness as it
was."""

import pytest

from fss_tpu_torch.utils import profiling
from port_bench import generator, spans
from port_bench.tests import tiny

OFF = 1_700_000_000_000_000_000  # wall clock - monotonic clock, ns

# Two requests of Dcf.eval, us on the trace's clock: (name, id, parent,
# start, end).
SPANS = [
    ("launch.dcf_eval", 3, 2, 115, 125),
    ("ops.dcf.eval_packed", 2, 1, 110, 130),
    ("ops.dcf.finalize", 4, 1, 140, 190),
    ("api.Dcf.eval", 1, 0, 100, 200),
    ("launch.dcf_eval", 7, 6, 315, 325),
    ("ops.dcf.eval_packed", 6, 5, 310, 330),
    ("ops.dcf.finalize", 8, 5, 340, 390),
    ("api.Dcf.eval", 5, 0, 300, 420),
]
# Runtime calls (ts, dur, correlation) and the device ops they queued
# (correlation, name, ts, dur). Idle: [232, 240], [250, 320], [360, 380].
CALLS = [(50, 1, 90), (118, 4, 1), (150, 2, 2), (160, 2, 3), (318, 4, 4),
         (345, 2, 5), (355, 2, 6), (450, 1, 91)]
OPS = [(1, "void dcf_eval_kernel<false, 1>", 122, 100),
       (2, "elementwise_a", 222, 10), (3, "elementwise_b", 240, 10),
       (4, "void dcf_eval_kernel<false, 1>", 320, 30),
       (5, "elementwise_a", 350, 10), (6, "elementwise_b", 380, 10)]
WINDOW = 390 - 122


def _record() -> profiling.Record:
    rec = profiling.Record()
    rec.anchors = [(OFF, 0), (OFF + 10**9, 10**9)]
    for name, sid, parent, a, b in SPANS:
        rec._kept.append((name, sid, parent, 1 + (sid > 4), 11, a * 1000,
                          b * 1000))
    return rec


def _events():
    calls = [{"ph": "X", "cat": "cuda_runtime",
              "name": "cudaLaunchKernel" if c < 90 else "cudaEventRecord",
              "ts": ts, "dur": dur, "args": {"correlation": c}}
             for ts, dur, c in CALLS]
    ops = [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": c}} for c, name, ts, dur in OPS]
    return calls + ops


def test_join_exact():
    j = spans.join(_record(), _events(), OFF)
    assert j.window_s == pytest.approx(WINDOW * 1e-6)
    assert j.launched == {"ops.dcf.finalize": 2, "api.Dcf.eval": 3,
                          "ops.dcf.eval_packed": 1, "launch.dcf_eval": 1}
    assert j.device_ms["ops.dcf.finalize"] == pytest.approx(0.020)
    assert j.device_ms["api.Dcf.eval"] == pytest.approx(0.085)
    assert j.idle_in["ops.dcf.finalize"] == pytest.approx(20 / WINDOW * 100)
    assert j.idle_innermost == pytest.approx({
        spans.NO_SPAN: 58 / WINDOW * 100,
        "api.Dcf.eval": 10 / WINDOW * 100,
        "ops.dcf.eval_packed": 5 / WINDOW * 100,
        "launch.dcf_eval": 5 / WINDOW * 100,
        "ops.dcf.finalize": 20 / WINDOW * 100})
    assert j.launch_inside == 100 and j.lost == 0
    assert j.host_ms["api.Dcf.eval"] == pytest.approx(0.110)
    got = spans.metrics(j)
    assert set(got) == set(spans.METRICS) - {"api_ms.gen"}
    assert got["finalize_launches.eval"] == 2
    assert got["finalize_ms.eval"] == pytest.approx(0.050)
    assert got["wrapper_ms.eval"] == pytest.approx(0.020)


def test_join_host_samples_leave_out_the_traced_window():
    """The profiler open over the second request (plus the settle):
    only the first is a host sample. A launch outside its span counts
    against the share inside."""
    j = spans.join(_record(), _events(), OFF, trace_span=(290e-6, 300e-6),
                   settle_s=20e-6)
    assert j.host_ms["api.Dcf.eval"] == pytest.approx(0.100)
    events = _events()
    events[4]["ts"] = 326  # the second dcf_eval launch, after its span
    assert spans.join(_record(), events, OFF).launch_inside == 50


def test_join_counts_a_launch_whose_device_record_is_lost():
    events = [e for e in _events() if e["args"]["correlation"] != 5
              or e["cat"] != "kernel"]
    j = spans.join(_record(), events, OFF)
    assert j.lost == 1 and j.launched["ops.dcf.finalize"] == 2
    assert j.device_ms["ops.dcf.finalize"] == pytest.approx(0.015)


def test_join_without_device_activity_reads_host_only():
    j = spans.join(_record(), [], OFF)
    assert j.window_s is None and j.launched == {} and j.host_ms


def test_run_records_the_measured_loop_on_cpu():
    loop = generator.closed_loop
    t = tiny.CELLS["dcf20.eval"]
    line = spans.run("dcf20.eval", tiny.SEED, tiny.SECONDS, True, True,
                     "cpu", cfg=t["cfg"], mix=t["mix"])
    assert generator.closed_loop is loop and profiling._active is None
    s = line["spans"]
    assert s["kept"] and not s["dropped"]
    assert {"api_ms.eval", "wrapper_ms.eval",
            "finalize_ms.eval"} <= set(s)
    assert s["api_ms.eval"] > s["wrapper_ms.eval"]
    assert line["checks"]["shares_wrong"]["value"] == 0
