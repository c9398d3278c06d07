"""The port's Half-Tree CUDA kernels against their plain PyTorch versions
on the card, and the reference's ChaCha Half-Tree golden vectors through
HalfTreeDpf("cuda").

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_half_tree.py
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
from fss_tpu_torch.api import HalfTreeDpf
from fss_tpu_torch.ops import eval_all_cuda, ht_cuda
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import half_tree_dpf as plain_ht

pytestmark = pytest.mark.gpu

NONCE = (0xABCD1234, 0x55AA55AA)
PRG1 = ChaCha(1, NONCE)
# Both instantiations of the kernels: B-7/B-8 (ChaCha) and B-15 and the AES
# Gen (AES-128-MMO, the JAX bench's first key).
PRGS = {"chacha": PRG1, "aes": AesMmo(1, (bytes(range(16)),))}
HASH_KEY = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, dev, bits=32):
    return blk.words(rng.integers(0, 2**bits, size=shape, dtype=np.uint64),
                     dev)


def _inputs(rng, n, batch, dev, lanes=False):
    """Alpha (or x) values below 2^n in the kernels' layout: [B] words for
    n <= 32 unless ``lanes``, else [B, 4] lanes."""
    if n <= 32 and not lanes:
        return _words(rng, (batch,), dev, n)
    vals = [int(v) % (1 << n) for v in rng.integers(0, 2**63, size=batch)]
    vals = [(v << 64 | v) % (1 << n) for v in vals]
    return blk.pack_inputs(vals, n, dev)


@pytest.mark.parametrize("layout", ["wire", "broadcast"])
@pytest.mark.parametrize("n", [1, 8, 16, 48, 128])
def test_eval_kernel_matches_plain(n, layout, cuda):
    rng = np.random.default_rng(n)
    batch = 1000
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda)
    wire, _ = ht_cuda.gen_batch(PRG1, groups.Bytes(), n, HASH_KEY, s0s,
                                alphas, _words(rng, (batch, 4), cuda))
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    s0, cws = {
        "wire": (s0s[:, 0].contiguous(), wire),
        "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous()),
    }[layout]
    for party in (0, 1):
        got = ht_cuda.eval_packed(s0, cws, xs, n, party, PRG1, HASH_KEY)
        want = ht_cuda.eval_packed_plain(s0, cws, xs, n, party, PRG1,
                                         HASH_KEY)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n,lanes", [(1, False), (1, True), (2, False),
                                     (16, False), (16, True), (48, True),
                                     (128, True)])
def test_gen_kernel_matches_plain(n, lanes, cuda):
    rng = np.random.default_rng(100 + n)
    batch = 500
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda, lanes)
    got = ht_cuda.gen_packed(s0s, alphas, n, PRG1, HASH_KEY)
    want = ht_cuda.gen_packed_plain(s0s, alphas, n, PRG1, HASH_KEY)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# One group of each kind the kernel's finalize takes (csrc/group.cuh).
GROUP_KINDS = {"xor": groups.Bytes(), "wrap": groups.Uint(32),
               "mod64": groups.Uint(64, (1 << 61) - 1),
               "mod128": groups.Uint(128, 1 << 127),
               "mod128np": groups.Uint(128, (1 << 127) - 1)}



# B-15 and B-7 on each row path (csrc/ht_eval.cu): wire rows (with AES
# through the TMA ring), one broadcast key, and wire rows at a 4-byte offset
# (the wrapper's aligned copy); a batch off every CTA's and box's multiple;
# x as one lane or four.
@pytest.mark.parametrize("layout", ["wire", "broadcast", "offset"])
@pytest.mark.parametrize("n,lanes", [(1, False), (2, False), (16, False),
                                     (16, True), (33, True), (128, True)])
@pytest.mark.parametrize("prg", list(PRGS))
def test_eval_kernel_row_paths(prg, n, lanes, layout, cuda):
    rng = np.random.default_rng(300 + n)
    batch = 1000 + 37
    P = PRGS[prg]
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda, lanes)
    wire, _ = ht_cuda.gen_batch(P, groups.Bytes(), n, HASH_KEY, s0s, alphas,
                                _words(rng, (batch, 4), cuda))
    xs = alphas.clone()
    xs.view(batch, -1)[1::2, 0] ^= 1
    if layout == "offset":
        flat = torch.empty(wire.numel() + 1, dtype=torch.int32, device=cuda)
        cws = flat[1:].view(wire.shape)
        cws.copy_(wire)
        assert cws.data_ptr() % 16
    else:
        cws = wire if layout == "wire" else wire[0].contiguous()
    s0 = (s0s[0, 0] if layout == "broadcast" else s0s[:, 0]).contiguous()
    for party in (0, 1):
        got = ht_cuda.eval_packed(s0, cws, xs, n, party, P, HASH_KEY)
        want = ht_cuda.eval_packed_plain(s0, cws, xs, n, party, P, HASH_KEY)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# The output CW inside the Gen kernel, for every group kind, against the
# plain Gen and against the output CW of the kernel's own leaves.
@pytest.mark.parametrize("kind", list(GROUP_KINDS))
@pytest.mark.parametrize("n,lanes", [(1, False), (1, True), (16, False),
                                     (16, True), (128, True)])
@pytest.mark.parametrize("prg", list(PRGS))
def test_gen_kernel_output_cw(prg, n, lanes, kind, cuda):
    rng = np.random.default_rng(600 + n)
    batch = 500
    P, g = PRGS[prg], GROUP_KINDS[kind]
    s0s = _words(rng, (batch, 2, 4), cuda)
    alphas = _inputs(rng, n, batch, cuda, lanes)
    betas = _words(rng, (batch, 4), cuda)
    got = ht_cuda.gen_packed(s0s, alphas, n, P, HASH_KEY, betas=betas,
                             group=g)
    want = ht_cuda.gen_packed_plain(s0s, alphas, n, P, HASH_KEY, betas=betas,
                                    group=g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cws, leaf0, leaf1 = ht_cuda.gen_packed(s0s, alphas, n, P, HASH_KEY)
    assert torch.equal(cws, got[0])
    assert torch.equal(got[1], plain_ht.output_cw(g, leaf0, leaf1, betas))


@pytest.mark.parametrize("kind", list(GROUP_KINDS))
@pytest.mark.parametrize("most", [2, 12])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 13])
def test_eval_all_kernel_matches_plain(n, most, kind, cuda):
    rng = np.random.default_rng(200 + n)
    g = GROUP_KINDS[kind]
    s0s = _words(rng, (1, 2, 4), cuda)
    cws, ocw = ht_cuda.gen_batch(PRG1, g, n, HASH_KEY, s0s,
                                 _inputs(rng, n, 1, cuda, lanes=True),
                                 _words(rng, (1, 4), cuda))
    for party in (0, 1):
        args = (PRG1, g, n, party, HASH_KEY, s0s[0, party], cws[0], ocw[0],
                most)
        assert torch.equal(eval_all_cuda.ht_eval_all(*args),
                           eval_all_cuda.ht_eval_all_plain(*args))


def test_kernels_count_launches(cuda):
    """Gen (its output CW in the kernel), Eval and EvalAll: 1, 1 and 2
    launches."""
    _build.reset_launches()
    d = HalfTreeDpf(10, groups.Uint(32), hash_key=HASH_KEY, device=cuda)
    s0s = np.arange(8, dtype=np.uint32).reshape(2, 4)
    cws, ocw = d.gen(s0s, 5, [1, 0, 0, 0])
    d.eval(0, s0s[0], cws, ocw, [4, 5])
    d.eval_all(1, s0s[1], cws, ocw)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "ht_gen": 1, "ht_eval": 1, "ht_eval_all": 2}


@pytest.mark.parametrize(
    "case", [c for c in json.loads((VEC / "half_tree.json").read_text())
             ["cases"] if c["prg"] == "chacha"],
    ids=lambda c: f"{c['group']}-{c['in_bits']}")
def test_golden_on_cuda(case, cuda):
    def hexw(h):
        return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()

    g = {"bytes": groups.Bytes(), "uint64": groups.Uint(64)}[case["group"]]
    d = HalfTreeDpf(case["in_bits"], g,
                    ChaCha(1, (case["nonce_lo"], case["nonce_hi"])),
                    hash_key=hexw(case["hash_key"]), device=cuda)
    s0s = np.stack([hexw(h) for h in case["s0s"]])
    cws, ocw = d.gen(s0s, int(case["alpha"], 0), hexw(case["beta"]))
    assert blk.to_numpy(cws).tobytes() == np.stack(
        [hexw(r) for r in case["cws"]]).tobytes()
    assert blk.to_numpy(ocw).tobytes() == bytes.fromhex(case["ocw"])
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys = blk.to_numpy(d.eval(party, s0s[party], cws, ocw, xs)).tobytes()
        assert ys == b"".join(bytes.fromhex(h) for h in case[f"ys{party}"])
        if "eval_all_digest0" in case:
            full = blk.to_numpy(d.eval_all(party, s0s[party], cws,
                                           ocw)).tobytes()
            assert hashlib.sha256(full).hexdigest() == \
                case[f"eval_all_digest{party}"]
