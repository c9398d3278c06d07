"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
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
from fss_tpu_torch.api import Dpf
from fss_tpu_torch.ops import dpf_cuda, eval_all_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import dpf as plain_dpf

pytestmark = pytest.mark.gpu

NONCE = (0xABCD1234, 0x55AA55AA)
PRG2 = ChaCha(2, NONCE)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"


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


@pytest.mark.parametrize("layout", ["wire", "packed", "broadcast"])
@pytest.mark.parametrize("n", [8, 16, 48, 128])
def test_eval_kernel_matches_plain(n, layout, cuda):
    rng = np.random.default_rng(n)
    batch = 1000
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    wire = dpf_cuda.gen_batch(PRG2, groups.Bytes(), n, s0s, alphas,
                              _words(rng, (batch, 4), cuda))
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    s0, cws, packed = {
        "wire": (s0s[:, 0].contiguous(), wire, False),
        "packed": (s0s[:, 0].contiguous(), dpf_cuda.pack_keys(wire, n)[0],
                   True),
        "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous(), False),
    }[layout]
    for party in (0, 1):
        got = dpf_cuda.eval_packed(s0, cws, xs, n, party, PRG2,
                                   packed=packed)
        want = dpf_cuda.eval_packed_plain(s0, cws, xs, n, party, PRG2,
                                          packed=packed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("layout", ["wire", "packed"])
@pytest.mark.parametrize("n", [8, 16, 48, 128])
def test_gen_kernel_matches_plain(n, layout, cuda):
    rng = np.random.default_rng(100 + n)
    batch = 1000
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    got = dpf_cuda.gen_packed(s0s, alphas, n, PRG2, layout=layout)
    want = dpf_cuda.gen_packed_plain(s0s, alphas, n, PRG2, layout=layout)
    if layout == "packed":  # (planes, ocw): the ocw zero without betas
        assert not got[0][1].any()
        got, want = (*got[0], *got[1:]), (*want[0], *want[1:])
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


GROUPS = (groups.Bytes(), groups.Uint(32), groups.Uint(64, (1 << 61) - 1),
          groups.Uint(128, 1 << 127), groups.Uint(128, (1 << 127) - 1))


@pytest.mark.parametrize("layout", ["wire", "packed"])
@pytest.mark.parametrize("n", [1, 16, 128])
def test_gen_output_cw_matches_plain(n, layout, cuda):
    """The Gen kernel given betas and the group: the output CW in the
    last wire row or the packed ocw, every group kind, against the plain
    version and against Gen plus the plain output_cw."""
    rng = np.random.default_rng(150 + n)
    batch = 1000
    s0s, betas = _words(rng, (batch, 2, 4), cuda), _words(rng, (batch, 4),
                                                          cuda)
    alphas = _inputs(rng, n, batch, cuda)
    bare = dpf_cuda.gen_packed(s0s, alphas, n, PRG2, layout)
    for g in GROUPS + (groups.Uint(64),):
        got = dpf_cuda.gen_packed(s0s, alphas, n, PRG2, layout, betas=betas,
                                  group=g)
        want = dpf_cuda.gen_packed_plain(s0s, alphas, n, PRG2, layout,
                                         betas=betas, group=g)
        keys = got[0] if layout == "wire" else got[0][0]
        assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
        ocw = dpf_cuda.output_cw(g, *bare[1:3], bare[4], betas)
        if layout == "wire":
            assert torch.equal(keys, want[0])
            assert torch.equal(keys[:, :n], bare[0][:, :n])
            assert torch.equal(keys[:, n, :4], ocw)
            assert not keys[:, n, 4:].any()
        else:
            assert torch.equal(keys, want[0][0])
            assert torch.equal(keys, bare[0][0])
            assert not bare[0][1].any()
            assert torch.equal(got[0][1], want[0][1])
            assert torch.equal(got[0][1], ocw)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 13])
def test_eval_all_kernel_matches_plain(n, cuda):
    """The one-launch EvalAll, every group kind, both parties, on the
    default plan and with subtrees of at most 2 levels (tops of n - 2),
    against its plain version and the breadth-first scheme; the seeds
    epilogue against its plain version."""
    rng = np.random.default_rng(200 + n)
    prg = ChaCha(2, NONCE)
    for g in GROUPS:
        s0s = _words(rng, (1, 2, 4), cuda)
        cws = plain_dpf.gen(prg, g, n, s0s, blk.pack_inputs(
            [int(rng.integers(0, 2**n))], n, cuda),
            _words(rng, (1, 4), cuda))[0]
        for party in (0, 1):
            s0 = s0s[0, party]
            want = plain_dpf.eval_all(prg, g, n, party, s0, cws)
            for most in (eval_all_cuda.SUBTREE_LEVELS, 2):
                got = eval_all_cuda.eval_all(prg, g, n, party, s0, cws, most)
                assert torch.equal(got, want), (g, party, most)
                assert torch.equal(got, eval_all_cuda.eval_all_plain(
                    prg, g, n, party, s0, cws, most))
                seeds = eval_all_cuda.expand_leaves(prg, n, party, s0, cws,
                                                    most)
                plain = eval_all_cuda.expand_leaves_plain(prg, n, party, s0,
                                                          cws, most)
                assert all(map(torch.equal, seeds, plain))


def test_kernels_count_launches(cuda):
    _build.reset_launches()
    d = Dpf(10, groups.Uint(32), device=cuda)
    s0s = np.arange(8, dtype=np.uint32).reshape(2, 4)
    cws = d.gen(s0s, 5, [1, 0, 0, 0])
    d.eval(0, s0s[0], cws, [4, 5])
    d.eval_all(1, s0s[1], cws)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "dpf_gen": 1, "dpf_eval": 1, "dpf_eval_all": 2}
    # Gen is one launch in either layout, the output CW in it.
    _build.reset_launches()
    d.gen_batch(s0s[None], [5], [[1, 0, 0, 0]], layout="packed")
    assert {k: v for k, v in _build.launches.items() if v} == {"dpf_gen": 1}


@pytest.mark.parametrize(
    "case", [c for c in json.loads((VEC / "dpf.json").read_text())["cases"]
             if c["prg"] == "chacha"],
    ids=lambda c: f"{c['group']}-{c['in_bits']}")
def test_golden_on_cuda(case, cuda):
    """The ChaCha golden DPF cases through Dpf on the card: Gen (the
    output CW in the kernel) in both layouts, both parties' shares and
    the EvalAll digests."""
    def hexw(h):
        return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()

    g = {"bytes": groups.Bytes(), "uint32": groups.Uint(32),
         "uint64": groups.Uint(64),
         "uint127": groups.Uint(128, 1 << 127)}[case["group"]]
    d = Dpf(case["in_bits"], g, ChaCha(2, (case["nonce_lo"],
                                           case["nonce_hi"])), device=cuda)
    s0s = np.stack([hexw(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0), hexw(case["beta"]))
    assert blk.to_numpy(cws).tobytes() == np.stack(
        [hexw(r) for r in case["cws"]]).tobytes()
    packed = d.gen_batch(s0s[None], [int(case["alpha"], 0)],
                         hexw(case["beta"])[None], layout="packed")
    assert torch.equal(packed.to_wire(case["in_bits"])[0], cws)
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys = blk.to_numpy(d.eval(party, s0s[party], cws, xs)).tobytes()
        assert ys == b"".join(bytes.fromhex(h) for h in case[f"ys{party}"])
        if "eval_all_digest0" in case:
            full = blk.to_numpy(d.eval_all(party, s0s[party], cws)).tobytes()
            assert hashlib.sha256(full).hexdigest() == \
                case[f"eval_all_digest{party}"]
