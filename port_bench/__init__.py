"""The benchmark of ``fss_tpu_torch`` on NVIDIA H100s: ``run.py`` runs one
cell of the repository's ``BENCHMARK.json``; the yardstick (traffic, the
reduction of traces to metrics, the peaks and work counts, the plain
reference and the comparison that decides ``correct``) lives here, apart
from the program it measures."""
