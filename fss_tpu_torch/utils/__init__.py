"""Profiling: spans at the port's layer boundaries (``span``, kept by
``record``) and a ``torch.profiler`` trace around a block
(``profile_trace``), the spans written into it."""

from fss_tpu_torch.utils.profiling import profile_trace, record, span

__all__ = ["profile_trace", "record", "span"]
