"""The traffic mixes and the generator, at tiny sizes on the CPU."""

import json
import time

import pytest

from port_bench import generator, harness
from port_bench.tests import faults, tiny

MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_mix_loads_and_draws_alike(name):
    mix = generator.Mix.load(harness.HERE / "traffic" / f"{name}.json")
    a = generator.Schedule.draw(mix, tiny.SEED)
    b = generator.Schedule.draw(mix, tiny.SEED)
    assert a == b and sorted(a.order) == list(range(mix.pool))
    assert len(a.keep) == mix.sample
    assert all(0 <= i < mix.sample_from for i in a.keep)


@pytest.mark.parametrize("name", MIXES)
def test_closed_loop_keeps_its_outstanding(name):
    mix = generator.Mix.load(harness.HERE / "traffic" / f"{name}.json",
                             sample_from=8, sample=3)
    sched = generator.Schedule.draw(mix, 5)
    inflight = []

    class Marker:
        def __init__(self):
            inflight.append(1)

        def synchronize(self):
            assert len(inflight) <= mix.outstanding
            inflight.pop()

    w = generator.closed_loop(lambda i: sched.input_set(i), Marker, mix,
                              0.05, sched)
    assert w.dispatched >= mix.outstanding and not inflight
    assert set(w.kept) == {i for i in sched.keep if i < w.dispatched}
    assert len(w.latencies) == w.dispatched


def test_percentile_nearest_rank():
    assert generator.percentile(list(range(1, 101)), 95) == 95
    assert generator.percentile([], 95) is None


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_cell_runs_tiny_on_cpu(workload, monkeypatch):
    faults.count_plain_launches(monkeypatch.setattr)
    t = tiny.CELLS[workload]
    out = harness.run(workload, tiny.SEED, tiny.SECONDS, False,
                      time.monotonic(), device="cpu", cfg=t["cfg"],
                      mix=t["mix"])
    line = out["line"]
    assert line["correct"], json.dumps(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in harness.Cell.find(workload).end_to_end}
    assert set(line["metrics"]) == names
