"""The port's ChaCha PRG, its import hygiene and its interop helpers.

ChaCha is checked against the numpy oracle, the JAX package's
implementation and the reference's own bytes (primitives.json).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.prg import chacha as jchacha
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.prg import chacha as tchacha
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
VEC = REPO / "tests" / "golden" / "vectors"
NONCE = (0xABCD1234, 0x55AA55AA)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


@pytest.mark.parametrize("mul", [1, 2, 4])
@pytest.mark.parametrize("rounds", [8, 20])
def test_chacha_matches_oracles(mul, rounds, rng):
    seeds = rng.integers(0, 2**32, size=(6, 4), dtype=np.uint32)
    outs = tchacha.ChaCha(mul, NONCE, rounds)(tblk.block(seeds))
    got = np.stack([tblk.to_numpy(o) for o in outs], axis=1)  # [6, mul, 4]
    for i, seed in enumerate(seeds):
        want = jchacha.chacha_prg_reference(seed, NONCE, mul, rounds)
        assert np.array_equal(got[i], want)
        assert np.array_equal(
            tchacha.chacha_prg_reference(seed, NONCE, mul, rounds), want)
    jouts = jchacha.ChaCha(mul, NONCE, rounds)(jblk.block(seeds))
    assert np.array_equal(got, np.stack([np.asarray(o) for o in jouts], 1))


def test_chacha_reference_bytes():
    for entry in json.loads((VEC / "primitives.json").read_text())["chacha"]:
        seed = np.frombuffer(bytes.fromhex(entry["seed"]), "<u4")
        nonce = (entry["nonce_lo"], entry["nonce_hi"])
        for mul, key in ((1, "out1"), (2, "out2"), (4, "out4")):
            outs = tchacha.ChaCha(mul, nonce)(tblk.block(seed))
            got = b"".join(tblk.to_numpy(o).tobytes() for o in outs)
            assert got == bytes.fromhex(entry[key]), f"mul={mul}"


def test_chacha_rejects_bad_parameters():
    with pytest.raises(ValueError):
        tchacha.ChaCha(3, NONCE)
    with pytest.raises(ValueError):
        tchacha.ChaCha(2, NONCE, rounds=7)


def test_port_imports_no_jax():
    """Every module of the package (walked, so the list cannot go stale),
    chip_smoke and the six sample twins (``samples/torch_*.py``) import
    neither JAX nor anything of fss_tpu."""
    code = ("import importlib, pathlib, pkgutil, sys, fss_tpu_torch, "
            "chip_smoke; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "fss_tpu_torch.__path__, 'fss_tpu_torch.')]; "
            "twins = sorted('samples.' + p.stem for p in "
            "pathlib.Path('samples').glob('torch_*.py')); "
            "assert len(twins) == 6, twins; "
            "[importlib.import_module(m) for m in mods + twins]; "
            "assert len(mods) >= 15, mods; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'fss_tpu' "
            "or m.startswith('fss_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_interop_round_trips(rng):
    s0s = rng.integers(0, 2**32, size=(7, 2, 4), dtype=np.uint32)
    t = to_cpu(s0s)
    assert t.shape == (7, 2, 4)
    assert np.array_equal(interop.to_numpy(t), s0s)

    n, B = 6, 300
    cws_t = rng.integers(0, 2**32, size=(n, 5, 3, 128), dtype=np.uint32)
    ocw = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    keys = interop.packed_keys_from_jax(cws_t, ocw, device="cpu")
    assert keys.cws_p.shape == (n, 5, B) and keys.batch == B
    assert np.array_equal(interop.to_numpy(keys.cws_p[2, 3]),
                          cws_t[2, 3].reshape(-1)[:B])
    back, ocw_back = interop.packed_keys_to_jax(keys)
    assert np.array_equal(back.reshape(n, 5, -1)[:, :, :B],
                          cws_t.reshape(n, 5, -1)[:, :, :B])
    assert np.array_equal(ocw_back, ocw)


@pytest.mark.parametrize("group", [jgroups.Bytes(), jgroups.Uint(32),
                                   jgroups.Uint(64, (1 << 61) - 1),
                                   jgroups.Uint(128, 1 << 127)],
                         ids=lambda g: g.name)
def test_interop_config(group):
    prg = jchacha.ChaCha(2, NONCE, 12)
    cfg = interop.dpf_config(24, group, prg)
    json.dumps(cfg)  # plain values only
    d = interop.dpf_from_config(cfg, device="cpu")
    assert d.in_bits == 24 and d.device.type == "cpu"
    assert d.prg == tchacha.ChaCha(2, NONCE, 12)
    assert d.group.name == group.name
    assert isinstance(d.group, tgroups.Bytes if group.name == "bytes"
                      else tgroups.Uint)
    assert interop.dpf_config(24, d.group, d.prg) == cfg
    # The card unless the caller asks for the CPU.
    assert interop.dpf_from_config(cfg).device.type == "cuda"
