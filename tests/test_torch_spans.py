"""The port's spans (``fss_tpu_torch.utils.profiling``): nothing kept and no
clock read while nothing records; nesting, requests and threads; the
capacity; the span tree of the DCF and DPF paths; the spans in
``profile_trace``'s Chrome trace, on its clock. The ``gpu`` case holds
the port's kernel launches in the card's trace to their ``launch.<kernel>``
spans; it skips without a CUDA device (decided in the ``cuda`` fixture).
The file imports no JAX: on a machine without it run the card's case as

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py
"""

import contextlib
import json
import pathlib
import threading
import types

import pytest
import torch

from fss_tpu_torch import _build, api, groups
from fss_tpu_torch.utils import profile_trace, profiling, record, span

N, B = 4, 4  # in_bits and keys: the plain versions run in milliseconds


def _inputs(device="cpu", n=N, b=B):
    g = torch.Generator().manual_seed(7)

    def words(shape, high=None):
        lo, hi = (-(1 << 31), 1 << 31) if high is None else (0, high)
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(device)
    return dict(s0s=words((b, 2, 4)), alphas=words((b,), 1 << n),
                betas=words((b, 4)), xs=words((b,), 1 << n))


def _calls(device="cpu", n=N, b=B):
    """Each traced call of the DCF and DPF paths, its inputs staged
    outside it: (span tree {name: parent's name}, call)."""
    x = _inputs(device, n, b)
    s0 = x["s0s"][:, 0].contiguous()
    out = {}
    for cls, ops in ((api.Dcf, "ops.dcf"), (api.Dpf, "ops.dpf")):
        scheme = cls(n, groups.Uint(32), device=device)
        cws = scheme.gen_batch(x["s0s"], x["alphas"], x["betas"])
        top = f"api.{cls.__name__}"
        out[f"{top}.gen_batch"] = (
            {f"{top}.gen_batch": None,
             f"{ops}.gen_packed": f"{top}.gen_batch"},
            lambda s=scheme: s.gen_batch(x["s0s"], x["alphas"], x["betas"]))
        out[f"{top}.eval"] = (
            {f"{top}.eval": None, f"{ops}.eval_packed": f"{top}.eval",
             f"{ops}.finalize": f"{top}.eval"},
            lambda s=scheme, c=cws: s.eval(0, s0, c, x["xs"]))
    return out


def test_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a site read the clock while off")

    marked = span("t.off")(lambda v: v + 1)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        monotonic_ns=clock, time_ns=clock))
    assert profiling._active is None
    assert marked(1) == 2
    monkeypatch.undo()
    with record() as rec:
        marked(1)
    marked(1)
    assert [s.name for s in rec.spans] == ["t.off"]
    assert profiling._active is None


def test_nesting_requests_and_threads():
    inner = span("t.inner")(lambda: threading.get_native_id())

    @span("t.outer")
    def outer():
        inner()
        inner()
        seen = []
        t = threading.Thread(target=lambda: seen.append(inner()))
        t.start()
        t.join()
        return seen[0]

    with record() as rec:
        other = outer()
        inner()
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
        assert s.start_ns <= s.end_ns
    (top,) = by["t.outer"]
    nested, alone = [], []
    for s in by["t.inner"]:
        (nested if s.parent == top.id else alone).append(s)
    assert len(nested) == 2 and len(alone) == 2
    assert all(s.request == top.request and s.thread == top.thread
               and top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
               for s in nested)
    # The thread's span and the one after the outer span open requests of
    # their own; ids are unique.
    assert all(s.parent == 0 for s in alone)
    assert len({top.request, *(s.request for s in alone)}) == 3
    assert {s.thread for s in alone} == {top.thread, other}
    assert len({s.id for s in rec.spans}) == 5


def test_capacity_and_one_record_at_a_time(monkeypatch):
    marked = span("t.cap")(lambda: None)
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with record() as rec:
        for _ in range(5):
            marked()
        with pytest.raises(RuntimeError, match="already"):
            with record():
                pass
    assert [s.id for s in rec.spans] == [1, 2, 3] and rec.dropped == 2
    assert len(rec.anchors) == 2


@pytest.mark.parametrize("call", ["api.Dcf.eval", "api.Dcf.gen_batch",
                                  "api.Dpf.eval", "api.Dpf.gen_batch"])
def test_span_tree_on_cpu(call):
    tree, fn = _calls()[call]
    with record() as rec:
        fn()
    names = {s.id: s.name for s in rec.spans}
    got = {s.name: names.get(s.parent) for s in rec.spans}
    assert got == tree and len(rec.spans) == len(tree)
    assert len({s.request for s in rec.spans}) == 1


@pytest.mark.parametrize("kernel,name", [(None, "launch.dcf_eval"),
                                         ("dcf_eval_aes",
                                          "launch.dcf_eval_aes")])
def test_launch_span_named_by_its_counter(kernel, name, monkeypatch):
    """``_build.launch`` is the span ``launch.<key of launches>``, kept
    when the launch fails too."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setitem(_build.launches, kernel or "dcf_eval", 0)
    with record() as rec:
        _build.launch("dcf_eval", lambda a, stream: 0, 1,
                      device=torch.device("cpu"), kernel=kernel)
        with pytest.raises(RuntimeError, match="CUDA error 7"):
            _build.launch("dcf_eval", lambda a, stream: 7, 1,
                          device=torch.device("cpu"), kernel=kernel)
    assert [s.name for s in rec.spans] == [name, name]
    assert _build.launches[kernel or "dcf_eval"] == 1


def test_profile_trace_holds_the_spans_on_its_clock(tmp_path):
    """Every torch op the profiler recorded for a ``Dcf.eval`` lies inside
    its ``api.Dcf.eval`` span, written as a ``port_span`` event."""
    _, fn = _calls(n=2, b=2)["api.Dcf.eval"]
    fn()
    with profile_trace(tmp_path, device="cpu") as log_dir:
        fn()
    (path,) = pathlib.Path(log_dir).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "port_span"]
    assert sorted(e["name"] for e in ours) == [
        "api.Dcf.eval", "ops.dcf.eval_packed", "ops.dcf.finalize"]
    (top,) = [e for e in ours if e["name"] == "api.Dcf.eval"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(top["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= top["ts"] + top["dur"]
                       for e in ops)
    assert profiling._active is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_launches_inside_their_spans_on_the_card(cuda, tmp_path):
    """At least 99% of the port kernels' launching runtime calls lie
    wholly inside their ``launch.<kernel>`` span once the spans' clock is
    mapped onto the trace's."""
    calls = _calls(cuda, n=16, b=1 << 12)
    for _, fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile_trace(tmp_path, device="cuda"):
        for _ in range(8):
            for _, fn in calls.values():
                fn()
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel"
               and any(f"{k}_kernel" in e["name"]
                       for k in ("dcf_eval", "dcf_gen", "dpf_eval",
                                 "dpf_gen"))}
    launch = [e for e in events if e.get("cat") == "port_span"
              and e["name"].startswith("launch.")]
    assert len(kernels) == 32 and len(launch) == 32
    inside = 0
    for c in events:
        symbol = kernels.get(c.get("args", {}).get("correlation"))
        if c.get("cat") != "cuda_runtime" or symbol is None:
            continue
        inside += any(
            s["ts"] <= c["ts"] and c["ts"] + c["dur"] <= s["ts"] + s["dur"]
            and f"{s['name'][len('launch.'):]}_kernel" in symbol
            for s in launch)
    assert inside >= 0.99 * len(kernels)
