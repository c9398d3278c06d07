"""The port's sharded paths and fss_crypto front door on the card.

A gloo world of 4 ranks on one card (``torch_ranks.run_all`` with CUDA
tensors; NCCL refuses two ranks on one device) runs every function of
``fss_tpu_torch.parallel.mesh``, and each rank's outputs are held against
the unsharded path on the card: the EvalAll kernels' full domain, sliced;
the VDPF's two-level proof recomputed from the unsharded pi~ by the plain
chain; the VDMPF's shard proofs recomputed from each shard's BatchEval,
merged by the plain chain. The front door's Eval takes tensors on the card
and returns its shares there. Byte-exact (tolerance 0: integer crypto).

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py
"""

import numpy as np
import pytest
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import crypto
from fss_tpu_torch import groups
from fss_tpu_torch.ops import eval_all_cuda, vdpf_cuda
from fss_tpu_torch.parallel import spawn
from fss_tpu_torch.schemes import vdpf as tvdpf
import torch_ranks as R

pytestmark = pytest.mark.gpu

N = 1 << R.BITS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build()  # the ranks load the libraries and build none
    keys = R.make_keys()
    return keys, spawn.run(R.run_all, 4, (keys, "cuda"), backend="gloo",
                           wait_s=300)


def _w(a, dev):
    return blk.words(a, dev)


def test_sharded_paths_match_unsharded_card_path(world, cuda):
    K, results = world
    S = R.schemes(cuda)
    s0 = [_w(K["s0s"][p], cuda) for p in (0, 1)]
    full = {}
    for p in (0, 1):
        full["dpf", p] = S["dpf"].eval_all(p, s0[p], _w(K["dpf"], cuda))
        full["dcf", p] = S["dcf"].eval_all(p, s0[p], _w(K["dcf"], cuda))
        full["ht", p] = S["ht"].eval_all(p, s0[p], *(_w(a, cuda)
                                                     for a in K["ht"]))
        full["grotto", p] = S["grotto"].eval_all(p, s0[p],
                                                 _w(K["grotto"], cuda))
    for res in results:
        assert {"dpf_eval_all", "dcf_eval_all", "ht_eval_all", "dpf_eval",
                "vdpf_eval", "feistel_route", "blake3_chain",
                "blake3_xor_hash"} <= set(res["launches"])
    for shards in R.SHARDS:
        rows = N // shards
        for rank, res in enumerate(results):
            idx = res["coord"][1] if shards == 2 else rank
            for (scheme, p), want in full.items():
                got = res["domain", shards][scheme, p]
                assert np.array_equal(got, blk.to_numpy(
                    want[idx * rows:(idx + 1) * rows])), (scheme, p, rank)
            a0, a1 = (res["domain", shards]["pir", p] for p in (0, 1))
            assert np.array_equal(a0 + a1, K["db"][R.PIR_INDEX])


@pytest.mark.parametrize("shards", R.SHARDS)
def test_vdpf_two_level_proof_on_card(shards, world, cuda):
    """The ranks' shares equal the unsharded EvalAll's; pi equals the
    chain (plain) from cs over each shard's chain (plain) of the
    unsharded pi~, for both parties on every rank."""
    K, results = world
    v = R.schemes(cuda)["vdpf"]
    cws, cs, ocw = (_w(a, cuda) for a in K["vdpf"])
    captured = {}

    def keep(pts, c):
        captured["pts"] = pts.clone()
        return c

    ys, _ = tvdpf.leaf_outputs(
        lambda a, b: vdpf_cuda.xor_hash(v.hashes, a, b), keep, v.group, 0,
        *eval_all_cuda.expand_leaves(v.prg, R.BITS, 0,
                                     _w(K["vdpf_s0s"][0], cuda), cws),
        cs, ocw)
    rows = N // shards
    level1 = torch.stack([vdpf_cuda.prove_plain(
        v.hashes, captured["pts"][i * rows:(i + 1) * rows], cs)
        for i in range(shards)])
    want = blk.to_numpy(vdpf_cuda.prove_plain(v.hashes, level1, cs))
    for rank, res in enumerate(results):
        idx = res["coord"][1] if shards == 2 else rank
        for p in (0, 1):
            y, pi = res["domain", shards]["vdpf", p]
            assert np.array_equal(pi, want), (rank, p)
        y0 = res["domain", shards]["vdpf", 0][0]
        assert np.array_equal(y0, blk.to_numpy(ys[idx * rows:
                                                  (idx + 1) * rows]))


@pytest.mark.parametrize("shards", R.SHARDS)
def test_vdmpf_shard_proofs_on_card(shards, world, cuda):
    """Each shard's BatchEval (tree fold) of the zero-padded points,
    recomputed here unsharded on the card; the ranks' shares are theirs
    and pi is the plain chain from zero over their proofs."""
    K, results = world
    v = R.schemes(cuda)["vdmpf"]
    eta = len(K["vdmpf_xs"])
    rows = -(-eta // shards)
    xs = np.zeros(rows * shards, np.uint32)
    xs[:eta] = K["vdmpf_xs"]
    for p in (0, 1):
        key = R.vdmpf_key(K["vdmpf"][p], cuda)
        outs = [v.batch_eval(p, key, xs[i * rows:(i + 1) * rows])
                for i in range(shards)]
        want = blk.to_numpy(vdpf_cuda.prove_plain(
            v.hashes, torch.stack([o[1] for o in outs]),
            torch.zeros((4, 4), dtype=torch.int32, device=cuda)))
        for rank, res in enumerate(results):
            idx = res["coord"][0] if shards == 2 else rank
            y, pi, shape = res["data", shards]["vdmpf", p]
            keep = min(rows, eta - idx * rows)
            assert shape == (eta, 4) and np.array_equal(pi, want)
            assert np.array_equal(y, blk.to_numpy(outs[idx][0][:keep]))


def test_data_by_domain_mesh_on_card(world, cuda):
    K, results = world
    d = R.schemes(cuda)["dpf"]
    half = N // 2
    for p in (0, 1):
        full = [blk.to_numpy(d.eval_all(p, _w(K["mesh_s0s"][i, p], cuda),
                                        _w(K["mesh_cws"][i], cuda)))
                for i in range(R.MESH_KEYS)]
        for res in results:
            i, j = res["coord"]
            want = np.stack([f[j * half:(j + 1) * half]
                             for f in full[2 * i:2 * i + 2]])
            assert np.array_equal(res["mesh2d", p], want)


@pytest.mark.parametrize("cls,prg", [("Dpf", "chacha"),
                                     ("Dcf", "aes128_mmo")])
def test_front_door_eval_on_card(cls, prg, cuda):
    """Eval of CUDA int32 tensors returns CUDA shares, equal to the CPU
    front door's; gen and eval_all refuse CUDA tensors with the
    reference's message; tensors on two devices are refused."""
    n = 12
    dev, cpu = (getattr(crypto, cls)(n, "uint", prg, device=d)
                for d in ("cuda", "cpu"))
    rng = np.random.default_rng(n)
    s0s = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 4),
                                        dtype=np.int32))
    beta = torch.tensor([7, 0, 0, 0], dtype=torch.int32)
    cws = dev.gen(s0s, 1000, beta)
    assert cws.device.type == "cpu" and torch.equal(
        cws, cpu.gen(s0s, 1000, beta))
    x = torch.arange(1 << n, dtype=torch.int32)
    ys = []
    for p in (0, 1):
        y = dev.eval(p, s0s[p].to(cuda), cws.to(cuda), x.to(cuda))
        assert y.device.type == "cuda"
        assert torch.equal(y.cpu(), cpu.eval(p, s0s[p], cws, x))
        assert torch.equal(dev.eval_all(p, s0s[p], cws), y.cpu())
        ys.append(y)
    g = groups.Uint(32)
    rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0].cpu()
    want = (x == 1000) if cls == "Dpf" else (x < 1000)
    assert torch.equal(rec, torch.where(want, 7, 0).to(torch.int32))
    with pytest.raises(RuntimeError,
                       match="eval_all expects all tensors to be on cpu"):
        dev.eval_all(0, s0s[0].to(cuda), cws.to(cuda))
    with pytest.raises(RuntimeError, match="gen expects all tensors"):
        dev.gen(s0s.to(cuda), 1, beta.to(cuda))
    with pytest.raises(RuntimeError, match="on the same device"):
        dev.eval(0, s0s[0].to(cuda), cws, 1)
