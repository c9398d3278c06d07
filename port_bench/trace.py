"""The traced run: ``torch.profiler`` over a part of the measured window,
and its reduction to what the per-layer readers read.

On the card the profiler records only the device's activity (CUPTI:
kernels, copies, sets) and the host's CUDA runtime calls: recording every
host operation as well would slow the host's dispatch, which sets the pace
of some cells, and the trace would show idle time the untraced run does
not have. The traced window runs from the first traced device activity to
the end of the last: the profiler closes after a synchronize, so the work
queued in the window finishes inside it, and work queued before it opened
runs untraced. What the reduction keeps (a
``Summary``, small enough to send between processes): the window and the
device's busy time within it (the union of every kernel, copy and set),
each kernel name's launches and seconds, the ten names of most device
time and the ten longest idle gaps, each named by the host's CUDA call at
its middle, if any.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import pathlib
import warnings

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "user_annotation", "cpu_op")
NO_CALL = "host: no CUDA call (Python and library work)"
# The port's kernel symbols (csrc/*.cu): every other kernel is a library's.
PORT_KERNELS = (
    "dpf_eval_kernel", "dpf_gen_kernel", "dpf_eval_all_kernel",
    "dcf_eval_kernel", "dcf_gen_kernel", "dcf_eval_all_kernel",
    "ht_eval_kernel", "ht_gen_kernel", "ht_eval_all_kernel",
    "blake3_xor_hash_kernel", "blake3_hash64_kernel", "blake3_chain_kernel",
    "sha256_xor_hash_kernel", "sha256_hash64_kernel", "sha256_chain_kernel",
    "vdpf_eval_kernel", "feistel_kernel")


class Tracer:
    """Opens and closes the profiler inside a running loop, then writes the
    trace to ``path`` (gzip)."""

    def __init__(self, path, device):
        import torch
        self.torch, self.path, self.device = torch, pathlib.Path(path), device
        self.prof = None

    def open(self) -> None:
        prof = self.torch.profiler
        self.prof = prof.profile(activities=[
            prof.ProfilerActivity.CUDA if self.device.type == "cuda"
            else prof.ProfilerActivity.CPU])
        self.prof.__enter__()

    def warm(self) -> None:
        """Open and close once, in set-up: the first start of the profiler
        in a process takes seconds."""
        self.open()
        self.torch.ones(8, device=self.device).sum()
        self.close()

    def close(self) -> None:
        if self.device.type == "cuda":
            # Work queued in the window finishes inside the trace.
            self.torch.cuda.synchronize(self.device)
        with warnings.catch_warnings():  # one cycle: nothing to keep
            warnings.filterwarnings("ignore", "Warning: Profiler clears")
            self.prof.__exit__(None, None, None)

    def export(self):
        """Write the trace; return its events."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        plain = self.path.with_suffix("")
        self.prof.export_chrome_trace(str(plain))
        raw = plain.read_bytes()
        plain.unlink()
        with gzip.open(self.path, "wb", compresslevel=1) as f:
            f.write(raw)
        return json.loads(raw)["traceEvents"]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [launches, seconds]
    device_ops: list  # [[name, seconds]] the ten of most device time
    idle_gaps: list  # [[host activity, seconds]] the ten longest gaps

    def select(self, *stems, port=None):
        """(launches, seconds) of kernels whose name holds one of
        ``stems``; with ``port`` False, of the kernels not the port's."""
        n = s = 0
        for name, (count, secs) in self.kernels.items():
            ours = any(k in name for k in PORT_KERNELS)
            if (stems and any(k in name for k in stems)) or (
                    port is False and not ours):
                n, s = n + count, s + secs
        return n, s


def _union(spans: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end] rows."""
    if not len(spans):
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0])]
    merged = [spans[0].copy()]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append(np.array([a, b]))
    return np.array(merged)


def summarize(events) -> Summary | None:
    """Reduce a chrome trace's events; None when it holds none."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e
          and e.get("cat") in DEVICE_CATS + HOST_CATS]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    bounds = dev or xs  # the CPU's trace has no device activity
    if not bounds:
        return None
    w0 = min(float(e["ts"]) for e in bounds)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in bounds)
    spans = np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                      for e in dev]).reshape(-1, 2)
    merged = _union(spans)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"]) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    gaps = []
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    for a, b in edges:
        if b > a:
            gaps.append((b - a, (a + b) / 2))
    gaps = sorted(gaps, reverse=True)[:10]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    h0 = np.array([float(e["ts"]) for e in host])
    h1 = h0 + np.array([float(e["dur"]) for e in host])
    named = []
    for length, mid in gaps:
        on = np.nonzero((h0 <= mid) & (h1 >= mid))[0] if len(host) else []
        name = (NO_CALL if not len(on) else
                host[int(on[np.argmin(h1[on] - h0[on])])]["name"])
        named.append([name, length * 1e-6])
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   kernels=kernels,
                   device_ops=[[n, v[1]] for n, v in top],
                   idle_gaps=named)
