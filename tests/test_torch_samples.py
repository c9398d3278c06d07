"""The six sample twins (``samples/torch_*.py``) run in-process on the CPU
(``main("cpu")``: the plain PyTorch versions), each printing the success
lines of its JAX sample; and the port's trace of a block
(``fss_tpu_torch.utils.profile_trace``; its spans:
``tests/test_torch_spans.py``). The twins on the card: ``chip_smoke.py``
phase 8."""

import importlib
import json
import pathlib

import pytest
import torch

from fss_tpu_torch.utils import profile_trace
from torch_threads import one_torch_thread  # noqa: F401

# Each twin and its success lines on the CPU, each given by the pieces it
# holds (tests/test_samples.py's needles for the JAX samples among them).
SAMPLES = {
    "torch_dpf_dcf_basic": [
        ("DPF: f(42) = [7, 0, 0, 0]; zero elsewhere. OK",),
        ("DCF: f(x) = 604 for x < 42, 0 otherwise. OK",)],
    "torch_dpf_batched_gpu": [
        ("1024 instances evaluated at their alphas via plain PyTorch: all "
         "reconstruct to beta. OK",)],
    "torch_dpf_packed_pipeline": [
        ("1024 instances through the packed gen->eval pipeline: reconstruct "
         "OK; to_wire() matches the wire-format gen. OK",)],
    "torch_vdpf_vdmpf_verified": [
        ("VDPF: 64 points evaluated, f(345) = 604, proofs match. OK",),
        ("VDPF: tampered evaluation rejected by Verify. OK",),
        ("VDMPF: 30-point function, 256 queries reconstruct, proofs match. "
         "OK",)],
    "torch_pir_gpu": [("PIR: row ", "x16-word database retrieved privately",
                       "...). OK")],
    "torch_dcf_mod_groups": [
        (f"DCF over {g} ", ": beta below alpha, zero above. OK")
        for g in ("Z_(1e9+7)", "Z_(2^61-1)", "Z_(2^127)", "Z_(2^127-1)")],
}


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_twin(name, capsys):
    importlib.import_module(f"samples.{name}").main("cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(SAMPLES[name]), lines
    for line, pieces in zip(lines, SAMPLES[name]):
        assert all(piece in line for piece in pieces), (line, pieces)


def test_profile_trace_cpu(tmp_path):
    """A Chrome trace of the block in the directory, naming the torch ops
    that ran; the card is asked for unless the CPU is named, and without
    one that raises."""
    with profile_trace(tmp_path / "t", device="cpu") as log_dir:
        torch.arange(4096).cumsum(0)
    traces = list(pathlib.Path(log_dir).glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::cumsum" in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profile_trace(tmp_path / "u"):
                pass
