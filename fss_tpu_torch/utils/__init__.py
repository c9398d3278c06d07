"""Profiling helpers: a ``torch.profiler`` trace around a block, and the
items/s of a step that returns a checksum."""

from fss_tpu_torch.utils.profiling import profile_trace, throughput

__all__ = ["profile_trace", "throughput"]
