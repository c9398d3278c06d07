"""Profiling helpers.

Counterpart of ``fss_tpu.utils.profiling``: ``profile_trace`` records a
``torch.profiler`` trace (CPU activity, and the card's kernels and copies
on a CUDA device) and writes it as a Chrome trace, which Perfetto and
``chrome://tracing`` open; ``throughput`` times a step by the
end-of-queue checksum.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir, device="cuda"):
    """Trace the block and write ``log_dir/trace.<pid>.<ns>.json``:

        with profile_trace("build/trace"):
            run_step()

    On a CUDA device the trace holds the card's activity too (each
    kernel under its symbol); the block's work is synchronised before
    the trace stops. The CPU alone is traced only when ``device`` is the
    CPU. Yields ``log_dir``.
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
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def throughput(step, args, items_per_iter: int, iters: int = 8,
               warmup: bool = True) -> float:
    """items/s of ``step(*args)``, which returns a checksum tensor.

    Queues ``iters`` steps and fetches only the last checksum
    (``.item()``): the card's stream runs them in order, so the time is
    sustained execution, with no host round trip between steps.
    """
    if warmup:
        step(*args).item()
    t0 = time.perf_counter()
    for _ in range(iters):
        chk = step(*args)
    chk.item()
    dt = (time.perf_counter() - t0) / iters
    return items_per_iter / dt
