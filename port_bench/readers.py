"""What the metric readers (``metrics/<name>.py``) share: each reads one
number from the run's ``harness.Ctx``, or None when there is nothing to
read."""

from __future__ import annotations

from port_bench import generator, roofline


def rate(ctx):
    """Items completed in the window a second."""
    if not ctx.completed:
        return None
    return ctx.completed * ctx.items / ctx.seconds


def mean_ms(values):
    return sum(values) / len(values) * 1e3 if values else None


def p95_ms(ctx):
    p = generator.percentile(ctx.latencies, 95)
    return None if p is None else p * 1e3


def idle_share(ctx):
    """Percent of the traced window in which no device activity ran."""
    s = ctx.summary
    if s is None or s.window_s <= 0:
        return None
    return (1 - s.busy_s / s.window_s) * 100


def launches(ctx, kernels):
    """The port's launches of ``kernels`` a request (its own counters)."""
    n = sum(ctx.launches.get(k, 0) for k in kernels)
    return n / ctx.dispatched if n and ctx.dispatched else None


def kernel_roofline(ctx, stem: str, work):
    """Percent of the least time for ``work`` = (ops, bytes), a launch,
    over the traced device time a launch of kernels named ``stem``."""
    if ctx.summary is None:
        return None
    n, secs = ctx.summary.select(stem)
    if not n or secs <= 0:
        return None
    least, _ = roofline.least_seconds(*work)
    return least / (secs / n) * 100

