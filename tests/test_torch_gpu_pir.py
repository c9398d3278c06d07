"""Two-server PIR on the card: the contraction kernel
(``csrc/pir_contract.cu``) against its plain int64 version at odd shapes,
``eval_all_batch`` against ``eval_all`` a key, ``Dpf.pir_answer`` at 20
bits against the benchmark's plain reference, and
``parallel.mesh.pir_lookup_sharded`` through the same contraction on a
gloo world of two ranks sharing the card. Byte-exact (tolerance 0:
integer crypto).

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). The file imports no JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_pir.py
"""

import numpy as np
import pytest
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf
from fss_tpu_torch.ops import eval_all_cuda, pir_cuda
from fss_tpu_torch.parallel import mesh as pm
from fss_tpu_torch.parallel import spawn
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from port_bench.reference import pir as ref

pytestmark = pytest.mark.gpu

NONCE = (0x13579BDF, 0x2468ACE0)
SHARDED_BITS, SHARDED_WORDS, SHARDED_ROW = 12, 64, 3001


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(g, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=g, device=dev,
                         dtype=torch.int32)


# (queries, rows, cols): N = 2, 2^10, 2^20 at D <= 64; D = 1, 3, 64, 7680
# at N <= 2^12; Q = 1, 32, 64 (and Q = 5, 17 inside the 32-query tier).
SHAPES = [(1, 2, 64), (32, 2, 3), (64, 2, 1), (32, 1 << 10, 64),
          (5, 1 << 10, 3), (1, 1 << 20, 64), (32, 1 << 20, 64),
          (64, 1 << 20, 64), (17, 1 << 20, 16), (64, 1 << 12, 1),
          (32, 1 << 12, 3), (1, 1 << 12, 7680), (64, 1 << 11, 7680)]


@pytest.mark.parametrize("queries,rows,cols", SHAPES)
@pytest.mark.parametrize("layout", ["shares", "words", "offset"])
def test_contract_matches_int64(cuda, queries, rows, cols, layout):
    """The selectors as word 0 of EvalAll shares [Q, N, 4], as a
    contiguous [Q, N], or with the table one row off its allocation (the
    kernel's one-word loads where D is even)."""
    g = torch.Generator(device=cuda).manual_seed(queries * rows + cols)
    full = _words(g, (queries, rows, 4), cuda)
    sel = full[:, :, 0] if layout != "words" else full[:, :, 0].contiguous()
    db = _words(g, (rows + 1, cols), cuda)
    db = db[1:] if layout == "offset" else db[:rows]
    before = _build.launches["pir_contract"]
    got = pir_cuda.contract(sel, db)
    torch.cuda.synchronize()
    assert _build.launches["pir_contract"] == before + 1
    want = pir_cuda.contract_plain(sel, db)
    assert torch.equal(got, want)


@pytest.mark.parametrize("in_bits", [1, 2, 11, 20])
@pytest.mark.parametrize("prg", ["chacha", "aes"])
@pytest.mark.parametrize("group", [groups.Uint(32), groups.Bytes()],
                         ids=["uint32", "bytes"])
def test_eval_all_batch_matches_eval_all(cuda, in_bits, prg, group):
    """The batch's launches, made in one call, give each key's EvalAll."""
    prg2 = ChaCha(2, NONCE) if prg == "chacha" else AesMmo(
        2, (bytes(range(16)), bytes(range(16, 32))))
    rng = np.random.default_rng(in_bits)
    dpf = Dpf(in_bits, group, prg2, device=cuda)
    s0s = blk.words(rng.integers(0, 2**32, size=(3, 2, 4)), cuda)
    cws = dpf.gen_batch(s0s, rng.integers(0, 1 << in_bits, size=3),
                        blk.words(rng.integers(0, 2**32, size=(3, 4)), cuda))
    kernel = "dpf_eval_all" + ("" if prg == "chacha" else "_aes")
    before = dict(_build.launches)
    got = eval_all_cuda.eval_all_batch(prg2, group, in_bits, 1,
                                       s0s[:, 1].contiguous(), cws)
    counts = _build.launched((kernel,), before)
    assert counts[kernel] == 3 * len(eval_all_cuda.plan(in_bits))
    want = torch.stack([dpf.eval_all(1, s0s[i, 1], cws[i]) for i in range(3)])
    assert torch.equal(got, want)


def test_pir_answer_20_bits(cuda):
    n, queries, cols = 20, 3, 64
    rng = np.random.default_rng(20)
    dpf = Dpf(n, groups.Uint(32), ChaCha(2, NONCE), device=cuda)
    s0s = blk.words(rng.integers(0, 2**32, size=(queries, 2, 4)), cuda)
    rows = rng.integers(0, 1 << n, size=queries)
    betas = torch.zeros((queries, 4), dtype=torch.int32, device=cuda)
    betas[:, 0] = 1
    cws = dpf.gen_batch(s0s, rows, betas)
    g = torch.Generator(device=cuda).manual_seed(20)
    db = _words(g, (1 << n, cols), cuda)
    before = dict(_build.launches)
    a0, a1 = (dpf.pir_answer(p, s0s[:, p], cws, db) for p in (0, 1))
    counts = _build.launched(("dpf_eval_all", "pir_contract"), before)
    assert counts == {"dpf_eval_all": 2 * 2 * queries, "pir_contract": 2}
    s0 = blk.u64(s0s)
    keys = ref.keys(NONCE, 20, n, s0, torch.as_tensor(rows, device=cuda))
    want = ref.answers(NONCE, 20, n, 0, s0[:, 0], keys, blk.u64(db))
    assert torch.equal(blk.u64(a0), want)
    got = (blk.u64(a0) + blk.u64(a1)) & blk.MASK32
    assert torch.equal(got, blk.u64(db)[torch.as_tensor(rows, device=cuda)])


def _sharded_rank(rank, world, s0s, cws, db):
    """Rank ``rank``'s PIR answer shares of both parties over its rows of
    the table, through ``pir_lookup_sharded``, and its launches."""
    dev = torch.device("cuda", torch.cuda.current_device())
    m = pm.make_mesh(world, axis_names=("domain",))
    rows = db.shape[0] // world
    local = blk.words(db[rank * rows:(rank + 1) * rows], dev)
    prg = ChaCha(2, NONCE)
    before = dict(_build.launches)
    out = [blk.to_numpy(pm.pir_lookup_sharded(prg, SHARDED_BITS, p, s0s[p],
                                              cws, local, m))
           for p in (0, 1)]
    return out, _build.launched(("dpf_eval_all", "pir_contract"), before)


def test_pir_lookup_sharded_through_the_contraction(cuda):
    rng = np.random.default_rng(12)
    dpf = Dpf(SHARDED_BITS, groups.Uint(32), ChaCha(2, NONCE), device=cuda)
    s0s = blk.words(rng.integers(0, 2**32, size=(2, 4)), cuda)
    cws = dpf.gen(s0s, SHARDED_ROW, [1, 0, 0, 0])
    db = rng.integers(0, 2**32, size=(1 << SHARDED_BITS, SHARDED_WORDS),
                      dtype=np.uint32)
    whole = [blk.to_numpy(dpf.pir_answer(p, s0s[p][None], cws[None],
                                         blk.words(db, cuda))[0])
             for p in (0, 1)]
    _build.build()  # the ranks load the libraries and build none
    results = spawn.run(_sharded_rank, 2, (blk.to_numpy(s0s),
                                           blk.to_numpy(cws), db),
                        backend="gloo", wait_s=300)
    for (a0, a1), counts in results:
        assert counts["pir_contract"] == 2
        assert np.array_equal(a0 + a1, db[SHARDED_ROW])
        # Each party's share is the unsharded answer's.
        assert np.array_equal(a0, whole[0]) and np.array_equal(a1, whole[1])
