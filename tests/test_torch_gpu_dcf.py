"""The port's DCF CUDA kernels against their plain PyTorch versions on the
card, and the reference's ChaCha DCF golden vectors through Dcf("cuda").

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_dcf.py
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dcf
from fss_tpu_torch.ops import dcf_cuda, eval_all_cuda
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

NONCE = (0xABCD1234, 0x55AA55AA)
PRG4 = ChaCha(4, NONCE)
AES4 = AesMmo(4, tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4)))
PRGS = {"chacha": PRG4, "aes": AES4}
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"

# One group per accumulator mode, and the two narrow moduli.
GROUPS = {
    "uint32": groups.Uint(32),                        # wrap
    "bytes": groups.Bytes(),                          # xor
    "uint64_mod": groups.Uint(64, (1 << 61) - 1),     # mod64
    "uint127": groups.Uint(128, 1 << 127),            # mod128
    "uint127m": groups.Uint(128, (1 << 127) - 1),     # mod128np
    "uint16_mod1000": groups.Uint(16, 1000),          # mod64, masked
    "uint32_mod2e16": groups.Uint(32, 1 << 16),       # wrap, pow2 mod
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, dev, bits=32):
    return blk.words(rng.integers(0, 2**bits, size=shape, dtype=np.uint64),
                     dev)


def _inputs(rng, n, batch, dev):
    """Alpha (or x) values below 2^n in the kernels' layout."""
    if n <= 32:
        return _words(rng, (batch,), dev, n)
    vals = [int(v) % (1 << n) for v in rng.integers(0, 2**63, size=batch)]
    vals = [(v << 64 | v) % (1 << n) for v in vals]
    return blk.pack_inputs(vals, n, dev)


@pytest.mark.parametrize("layout", ["wire", "broadcast"])
@pytest.mark.parametrize("n", [8, 16, 48, 128])
@pytest.mark.parametrize("gname", list(GROUPS))
def test_eval_kernel_matches_plain(gname, n, layout, cuda):
    g = GROUPS[gname]
    rng = np.random.default_rng(n)
    batch = 1000
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    wire = dcf_cuda.gen_batch(PRG4, g, n, "lt", s0s, alphas,
                              _words(rng, (batch, 4), cuda))
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    s0, cws = {
        "wire": (s0s[:, 0].contiguous(), wire),
        "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous()),
    }[layout]
    mode, vmask = dcf_cuda.group_mode(g), dcf_cuda.value_mask(g)
    for party in (0, 1):
        got = dcf_cuda.eval_packed(s0, cws, xs, n, party, PRG4, mode, vmask)
        want = dcf_cuda.eval_packed_plain(s0, cws, xs, n, party, PRG4, mode,
                                          vmask)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", ["wire", "broadcast"])
@pytest.mark.parametrize("n", [1, 20, 33, 128])
@pytest.mark.parametrize("pname", list(PRGS))
@pytest.mark.parametrize("gname", list(GROUPS))
def test_eval_points_fused_matches_plain_on_cpu(gname, pname, n, layout,
                                                cuda):
    """On the card ``eval_points`` is one launch with the shares
    epilogue; word for word the walk then ``finalize`` on the CPU."""
    g, prg = GROUPS[gname], PRGS[pname]
    rng = np.random.default_rng(300 + n)
    batch = 512
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    wire = dcf_cuda.gen_batch(prg, g, n, "lt", s0s, alphas,
                              _words(rng, (batch, 4), cuda))
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    for party in (0, 1):
        s0, cws = {
            "wire": (s0s[:, party].contiguous(), wire),
            "broadcast": (s0s[0, party].contiguous(), wire[0].contiguous()),
        }[layout]
        got = dcf_cuda.eval_points(prg, g, n, party, s0, cws, xs)
        cpu = [a.cpu() for a in (s0, cws, xs)]
        vo, so, t = dcf_cuda.eval_packed_plain(
            *cpu, n, party, prg, dcf_cuda.group_mode(g),
            dcf_cuda.value_mask(g))
        want = dcf_cuda.finalize(g, party, vo, so, t, cpu[1][..., n, 4:8])
        assert torch.equal(got.cpu(), want), party


@pytest.mark.parametrize("pname", list(PRGS))
def test_eval_is_one_launch_without_finalize(pname, cuda):
    """One ``Dcf.eval`` on the card: one ``dcf_eval`` launch, inside
    ``ops.dcf.eval_shares``, and no ``ops.dcf.finalize`` span."""
    d = Dcf(20, groups.Uint(32), PRGS[pname], device=cuda)
    rng = np.random.default_rng(5)
    s0s = _words(rng, (64, 2, 4), cuda)
    cws = d.gen_batch(s0s, _words(rng, (64,), cuda, 20),
                      _words(rng, (64, 4), cuda))
    xs = _words(rng, (64,), cuda, 20)
    kernel = "dcf_eval" + ("_aes" if pname == "aes" else "")
    _build.reset_launches()
    with profiling.record() as rec:
        d.eval(0, s0s[:, 0].contiguous(), cws, xs)
    assert {k: v for k, v in _build.launches.items() if v} == {kernel: 1}
    names = [s.name for s in rec.spans]
    assert sorted(names) == sorted(["api.Dcf.eval", "ops.dcf.eval_shares",
                                    f"launch.{kernel}"]), names


@pytest.mark.parametrize("pred", ["lt", "gt"])
@pytest.mark.parametrize("n", [8, 40])
@pytest.mark.parametrize("gname", list(GROUPS))
def test_gen_kernel_matches_plain(gname, n, pred, cuda):
    g = GROUPS[gname]
    rng = np.random.default_rng(100 + n)
    batch = 500
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    betas = _words(rng, (batch, 4), cuda)
    got = dcf_cuda.gen_packed(s0s, alphas, betas, n, PRG4, pred, g)
    want = dcf_cuda.gen_packed_plain(s0s, alphas, betas, n, PRG4, pred, g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 13])
@pytest.mark.parametrize("gname", list(GROUPS))
def test_eval_all_kernel_matches_plain(gname, n, cuda):
    g = GROUPS[gname]
    rng = np.random.default_rng(200 + n)
    prg = ChaCha(4, NONCE)
    s0s = _words(rng, (1, 2, 4), cuda)
    cws = dcf_cuda.gen_batch(PRG4, g, n, "lt", s0s,
                             _inputs(rng, n, 1, cuda),
                             _words(rng, (1, 4), cuda))[0]
    for party in (0, 1):
        for most in (eval_all_cuda.SUBTREE_LEVELS, 2):
            got = eval_all_cuda.dcf_eval_all(prg, g, n, party,
                                             s0s[0, party], cws, most)
            want = eval_all_cuda.dcf_eval_all_plain(prg, g, n, party,
                                                    s0s[0, party], cws, most)
            assert torch.equal(got, want), (party, most)


def test_kernels_count_launches(cuda):
    _build.reset_launches()
    d = Dcf(10, groups.Uint(32), device=cuda)
    s0s = np.arange(8, dtype=np.uint32).reshape(2, 4)
    cws = d.gen(s0s, 5, [1, 0, 0, 0])
    d.eval(0, s0s[0], cws, [4, 5])
    d.eval_all(1, s0s[1], cws)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "dcf_gen": 1, "dcf_eval": 1, "dcf_eval_all": 2}


@pytest.mark.parametrize(
    "case", [c for c in json.loads((VEC / "dcf.json").read_text())["cases"]
             if c["prg"] == "chacha"],
    ids=lambda c: f"{c['group']}-{c['in_bits']}-{c['pred']}")
def test_golden_on_cuda(case, cuda):
    def hexw(h):
        return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()

    g = {"bytes": groups.Bytes(), "uint64": groups.Uint(64),
         "uint127": groups.Uint(128, 1 << 127),
         "uint127m": groups.Uint(128, (1 << 127) - 1)}[case["group"]]
    d = Dcf(case["in_bits"], g, ChaCha(4, (case["nonce_lo"],
                                           case["nonce_hi"])),
            pred=case["pred"], device=cuda)
    s0s = np.stack([hexw(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0), hexw(case["beta"]))
    assert blk.to_numpy(cws).tobytes() == np.stack(
        [hexw(r) for r in case["cws"]]).tobytes()
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys = blk.to_numpy(d.eval(party, s0s[party], cws, xs)).tobytes()
        assert ys == b"".join(bytes.fromhex(h) for h in case[f"ys{party}"])
        if "eval_all_digest0" in case:
            full = blk.to_numpy(d.eval_all(party, s0s[party], cws)).tobytes()
            assert hashlib.sha256(full).hexdigest() == \
                case[f"eval_all_digest{party}"]
