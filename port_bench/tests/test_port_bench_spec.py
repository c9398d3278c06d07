"""BENCHMARK.json and the files its entries name: every cell's
configuration, traffic and metric readers are found by name."""

import json
import re

import pytest

from port_bench import generator, harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.Cell.find(workload)
    assert (harness.HERE / "systems" / f"{cell.cfg['system']}.py").exists()
    assert cell.system().System
    assert isinstance(cell.mix, generator.Mix)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_spec_shape():
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for c in SPEC["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
