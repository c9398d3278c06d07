"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level module name (``fss_tpu_torch`` begins with ``fss_tpu``)."""

import json
import subprocess
import sys

from port_bench import harness

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench import control, generator, harness, readers, roofline, trace
from port_bench.reference import chacha, tree
from port_bench.tests import tiny
for name in tiny.CELLS:
    cell = harness.Cell.find(name)
    cell.system()
    for m in cell.end_to_end + cell.per_layer:
        harness.reader(m["name"])
t = tiny.CELLS["dcf20.eval"]
harness.run("dcf20.eval", tiny.SEED, 0.2, True, time.monotonic(),
            device="cpu", cfg=t["cfg"], mix=t["mix"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_or_jax_package_loaded():
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fss_tpu_torch" in tops and "port_bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "fss_tpu"}


def test_forbidden_is_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "fss_tpu_torch_probe", sys)
    assert "fss_tpu" not in harness._forbidden()
    monkeypatch.setitem(sys.modules, "fss_tpu.probe", sys)
    assert "fss_tpu" in harness._forbidden()
