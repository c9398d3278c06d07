"""On the card (marked gpu; skips without one): each one-chip cell at its
own sizes through ``run.py`` for two seconds, correct, with its metrics."""

import json
import subprocess
import sys

import pytest

from port_bench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs only there")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dcf20.eval", "dcf20.gen"])
def test_cell_on_the_card(card, workload):
    run = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         workload, "--seed", str(2**31 + 5), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=harness.ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
