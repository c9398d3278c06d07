"""What decides ``correct``, shown to fail: the control (the reference in
the program's place with ChaCha8 where ChaCha20 is stated) on three seeds,
and a run driven whole (the look for a card skipped) with the timed path
broken underneath: its state left unchanged, half of its batch left out,
one answer altered. The cells run on one chip: no exchange between chips
to leave out."""

import json
import time

import pytest

from port_bench import control, harness
from port_bench.tests import faults, tiny

from fss_tpu_torch import api


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [tiny.SEED, 12, 2**31 + 3])
def test_control_fails(workload, seed):
    t = tiny.CELLS[workload]
    out = control.run(workload, seed, 8, device="cpu", cfg=t["cfg"],
                      mix=t["mix"])
    over = {k: v for k, v in out["numbers"].items()
            if v["value"] > v["limit"]}
    assert over, json.dumps(out)
    # The stated rounds in the same place pass.
    same = control.run(workload, seed, 20, device="cpu", cfg=t["cfg"],
                       mix=t["mix"])
    assert all(v["value"] == 0 for v in same["numbers"].values())


DCF_FAULTS = [("dcf20.eval", "eval", f) for f in faults.FAULTS] + \
    [("dcf20.gen", "gen_batch", f) for f in faults.FAULTS]


@pytest.mark.parametrize("workload,method,fault", DCF_FAULTS)
def test_fault_is_not_correct(workload, method, fault, monkeypatch):
    faults.count_plain_launches(monkeypatch.setattr)
    faults.plant(api.Dcf, method, fault, monkeypatch.setattr)
    t = tiny.CELLS[workload]
    out = harness.run(workload, tiny.SEED, tiny.SECONDS, False,
                      time.monotonic(), device="cpu", cfg=t["cfg"],
                      mix=t["mix"])
    assert out["line"]["correct"] is False
    assert out["line"]["failed"] > 0

