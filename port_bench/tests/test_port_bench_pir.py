"""The PIR cell ``pir20.answer`` cut to a size the CPU runs in seconds:
correct through the harness with the port's plain versions counted as
launches; its control (ChaCha8 in the program's place) and three faults
planted under ``api.Dpf.pir_answer`` read not correct; the contraction's
work count; and, on the card (marked gpu), the cell at its own sizes
through ``run.py``."""

import dataclasses
import functools
import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench import control, harness, roofline, roofline_pir, trace
from port_bench.reference import pir, tree
from port_bench.tests import faults, tiny

from fss_tpu_torch import api

WORKLOAD = "pir20.answer"
TINY = dict(cfg={"in_bits": 8},
            mix={"batch_log2": 2, "sample": 2, "sample_from": 4})


def count_plain_launches(put) -> None:
    """Count each plain version's call under its kernel, as the kernels'
    wrappers count their launches."""
    from fss_tpu_torch import _build
    from fss_tpu_torch.ops import eval_all_cuda, pir_cuda

    def counted(fn, kernel):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            _build.launches[kernel] += 1
            return fn(*args, **kwargs)
        return call

    put(eval_all_cuda, "eval_all_plain",
        counted(eval_all_cuda.eval_all_plain, "dpf_eval_all"))
    put(pir_cuda, "contract_plain",
        counted(pir_cuda.contract_plain, "pir_contract"))


def _run():
    return harness.run(WORKLOAD, tiny.SEED, tiny.SECONDS, False,
                       time.monotonic(), device="cpu", **TINY)


def test_tiny_cell_is_correct(monkeypatch):
    count_plain_launches(monkeypatch.setattr)
    out = _run()
    line = out["line"]
    assert line["correct"] is True, json.dumps(line)
    assert line["checks"]["answers_wrong"]["value"] == 0
    assert line["checks"]["kernels_not_launched"]["value"] == 0
    assert {"eval_rate", "setup_s"} <= set(line["metrics"])
    # Every kept request's every query was compared.
    assert out["notes"]["what"]["answers_wrong"].startswith("of ")
    assert int(out["notes"]["what"]["answers_wrong"].split()[1]) >= 4


@pytest.mark.parametrize("seed", [tiny.SEED, 12, 2**31 + 3])
def test_control_fails(seed):
    out = control.run(WORKLOAD, seed, 8, device="cpu", **TINY)
    n = out["numbers"]["answers_wrong"]
    # Every answer of the control is wrong.
    assert n["value"] > n["limit"]
    assert n["of"] == f"of {n['value']} compared", json.dumps(out)
    same = control.run(WORKLOAD, seed, 20, device="cpu", **TINY)
    assert same["numbers"]["answers_wrong"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    count_plain_launches(monkeypatch.setattr)
    faults.plant(api.Dpf, "pir_answer", fault, monkeypatch.setattr)
    line = _run()["line"]
    assert line["correct"] is False
    assert line["failed"] > 0


def test_contract_count():
    ops, nbytes = roofline_pir.pir_contract(32, 1 << 20, 64)
    assert ops == 2 * 32 * 2**20 * 64  # an IMAD at half the 128 lanes
    assert nbytes == 2**20 * 256 + 32 * 2**20 * 4 + 32 * 256
    least, by = roofline.least_seconds(ops, nbytes)
    assert by == "operations"
    assert least == pytest.approx(ops / roofline.INT_OPS_PER_S)
    assert least * 1e3 == pytest.approx(0.1284, abs=1e-4)
    ops, nbytes = roofline_pir.pir_contract(28, 1 << 20, 64)
    assert roofline.least_seconds(ops, nbytes)[1] == "bytes"


def test_kernel_readers_on_a_trace():
    """The cell's per-layer readers on a traced window of known launches:
    a request of 32 keys' two EvalAll launches and one contraction."""
    cell = harness.Cell.find(WORKLOAD)
    body, top, contract, requests = 65.6e-6, 13.1e-6, 285e-6, 10
    keys = 32 * requests
    summary = trace.Summary(
        window_s=1.0, busy_s=0.7, device_ops=[], idle_gaps=[], kernels={
            "void (anonymous namespace)::dpf_eval_all_kernel<1, "
            "fss::ChaChaPrg>(...)": [keys, keys * body],
            "void (anonymous namespace)::dpf_eval_all_kernel<6, "
            "fss::ChaChaPrg>(...)": [keys, keys * top],
            "void (anonymous namespace)::pir_contract_kernel<32, 2>(...)":
                [requests, requests * contract],
            "Memset (Device)": [requests, requests * 1e-6]})
    ctx = harness.Ctx(
        cfg=cell.cfg, mix=cell.mix, items=32 << 20, seconds=10.0,
        setup_s=1.0, completed=requests, dispatched=requests, latencies=[],
        dispatch_s=[0.004] * 3,
        launches={"dpf_eval_all": 2 * keys, "pir_contract": requests},
        summary=summary)
    got = {m["name"]: harness.reader(m["name"])(ctx) for m in cell.per_layer}
    least = roofline.least_seconds(*roofline.dpf_eval_all(20))[0]
    assert got["dpf_eval_all_roofline"] == pytest.approx(
        least / (body + top) * 100)
    least = roofline.least_seconds(
        *roofline_pir.pir_contract(32, 1 << 20, 64))[0]
    assert got["pir_contract_roofline"] == pytest.approx(
        least / contract * 100)
    assert got["launches.pir"] == 65
    assert got["dispatch_ms.pir"] == pytest.approx(4.0)
    assert got["idle_share.pir"] == pytest.approx(30.0)
    assert got["glue_ms.pir"] == pytest.approx(1e-3)  # the Memset
    assert got["p95_ms.pir"] is None  # no request timed
    timed = dataclasses.replace(ctx, latencies=[0.003] * 19 + [0.009])
    assert harness.reader("p95_ms.pir")(timed) == pytest.approx(3.0)


@pytest.mark.parametrize("walk_leaves", [1 << 24, 1 << 8])
@pytest.mark.parametrize("party", [0, 1])
def test_reference_walk_is_dpf_eval_all(walk_leaves, party, monkeypatch):
    """The reference's walk of several keys at once (in chunks of
    ``WALK_LEAVES`` leaves) gives word 0 of the frozen per-key EvalAll."""
    monkeypatch.setattr(pir, "WALK_LEAVES", walk_leaves)
    g = torch.Generator().manual_seed(9)
    n, queries, nonce = 7, 5, (0x243F6A88, 0x85A308D3)
    s0s = torch.randint(0, 1 << 32, (queries, 2, 4), generator=g)
    cws = pir.keys(nonce, 20, n, s0s, torch.randint(0, 1 << n, (queries,),
                                                    generator=g))
    got = pir.selectors(nonce, 20, n, party, s0s[:, party], cws)
    want = torch.stack([tree.dpf_eval_all(nonce, 20, pir.GROUP, n, party,
                                          s0s[q, party], cws[q])[:, 0]
                        for q in range(queries)])
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs only there")
    run = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         WORKLOAD, "--seed", str(2**31 + 5), "--seconds", "4",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {
        "pir_contract_roofline", "dpf_eval_all_roofline", "launches.pir",
        "dispatch_ms.pir", "idle_share.pir", "p95_ms.pir", "glue_ms.pir"}
