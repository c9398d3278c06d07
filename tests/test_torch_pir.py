"""Two-server PIR on the port, on the CPU: ``api.Dpf.pir_answer`` against
the benchmark's plain reference (``port_bench/reference/pir.py``, which
imports nothing of the port) and against the JAX package's
``pir_lookup_sharded`` word for word, the two parties' answers
against the table's row, ``ops/pir_cuda.contract_plain`` against an int64
contraction in numpy, ``eval_all_batch`` against ``eval_all`` a key, and
the checks of the entries' inputs. Byte-exact (tolerance 0: integer crypto)."""

import jax
import numpy as np
import pytest
import torch

from fss_tpu.parallel import mesh as jmesh
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf
from fss_tpu_torch.ops import eval_all_cuda, pir_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from port_bench.reference import pir as ref
from torch_jax import FAST_COMPILE

NONCE = (0x13579BDF, 0x2468ACE0)
ROUNDS = 20


def _case(in_bits, queries, cols, seed):
    """A Dpf on the CPU, the queries' seeds [Q, 2, 4], rows and keys, and
    a table [2^in_bits, cols]."""
    rng = np.random.default_rng(seed)
    dpf = Dpf(in_bits, groups.Uint(32), ChaCha(2, NONCE, ROUNDS),
              device="cpu")
    s0s = blk.words(rng.integers(0, 2**32, size=(queries, 2, 4)))
    rows = rng.integers(0, 1 << in_bits, size=queries)
    betas = torch.zeros((queries, 4), dtype=torch.int32)
    betas[:, 0] = 1
    cws = dpf.gen_batch(s0s, rows, betas)
    db = blk.words(rng.integers(0, 2**32, size=(1 << in_bits, cols)))
    return dpf, s0s, rows, cws, db


def _numpy_contract(sel, db):
    """sum_j sel[q, j] * db[j] mod 2^32 in numpy uint64 (wrapping mod 2^64,
    exact mod 2^32)."""
    s = blk.to_numpy(sel).astype(np.uint64)
    d = blk.to_numpy(db).astype(np.uint64)
    return ((s[:, :, None] * d[None]).sum(1) & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("in_bits,queries,cols", [
    (6, 1, 1), (7, 4, 64), (8, 7, 3), (9, 4, 1), (10, 7, 64)])
@pytest.mark.parametrize("party", [0, 1])
def test_pir_answer_matches_reference(in_bits, queries, cols, party):
    dpf, s0s, rows, cws, db = _case(in_bits, queries, cols, in_bits)
    got = dpf.pir_answer(party, s0s[:, party], cws, db)
    assert got.shape == (queries, cols) and got.dtype == torch.int32
    s0 = blk.u64(s0s)
    keys = ref.keys(NONCE, ROUNDS, in_bits, s0, torch.as_tensor(rows))
    assert torch.equal(blk.u64(cws), keys)  # the port's Gen: the reference's
    want = ref.answers(NONCE, ROUNDS, in_bits, party, s0[:, party], keys,
                       blk.u64(db))
    assert torch.equal(blk.u64(got), want)


@pytest.mark.parametrize("in_bits,queries,cols", [
    (6, 1, 1), (7, 4, 64), (8, 7, 3)])
@pytest.mark.parametrize("party", [0, 1])
def test_pir_answer_matches_jax(in_bits, queries, cols, party):
    """Each query's answer share equals the JAX package's
    ``pir_lookup_sharded`` (on a mesh of one device: its EvalAll, then the
    wrapping int32 contraction) on the same key and table."""
    dpf, s0s, _, cws, db = _case(in_bits, queries, cols, in_bits + 40)
    got = blk.to_numpy(dpf.pir_answer(party, s0s[:, party], cws, db))
    mesh = jmesh.make_mesh(1, axis_names=("domain",))
    s0, keys = blk.to_numpy(s0s[:, party]), blk.to_numpy(cws)
    table = blk.to_numpy(db).view(np.int32)
    lookup = jax.jit(lambda s, c, d: jmesh.pir_lookup_sharded(
        JChaCha(2, NONCE, ROUNDS), in_bits, party, s, c, d, mesh,
        axis="domain")).lower(s0[0], keys[0], table).compile(FAST_COMPILE)
    for q in range(queries):
        want = np.asarray(lookup(s0[q], keys[q], table)).view(np.uint32)
        assert np.array_equal(got[q], want), q


@pytest.mark.parametrize("in_bits,queries,cols", [(5, 3, 64), (9, 64, 2)])
def test_answers_reconstruct_the_rows(in_bits, queries, cols):
    dpf, s0s, rows, cws, db = _case(in_bits, queries, cols, 7)
    a0, a1 = (dpf.pir_answer(p, s0s[:, p], cws, db) for p in (0, 1))
    got = (blk.u64(a0) + blk.u64(a1)) & blk.MASK32
    assert torch.equal(got, blk.u64(db)[torch.as_tensor(rows)])


@pytest.mark.parametrize("queries,rows,cols,strided", [
    (1, 2, 1, False), (3, 100, 5, True), (64, 512, 3, True),
    (5, 40000, 2, False)])
def test_contract_plain_matches_int64(queries, rows, cols, strided):
    g = torch.Generator().manual_seed(rows)
    full = torch.randint(-2**31, 2**31, (queries, rows, 4), generator=g,
                         dtype=torch.int32)
    sel = full[:, :, 0] if strided else full[:, :, 0].contiguous()
    db = torch.randint(-2**31, 2**31, (rows, cols), generator=g,
                       dtype=torch.int32)
    got = pir_cuda.contract(sel, db)
    assert np.array_equal(blk.to_numpy(got), _numpy_contract(sel, db))


@pytest.mark.parametrize("in_bits", [1, 2, 6])
def test_eval_all_batch_is_eval_all_per_key(in_bits):
    dpf, s0s, _, cws, _ = _case(in_bits, 3, 1, in_bits)
    for party in (0, 1):
        got = eval_all_cuda.eval_all_batch(dpf.prg, dpf.group, in_bits,
                                           party, s0s[:, party].contiguous(),
                                           cws)
        want = torch.stack([dpf.eval_all(party, s0s[i, party], cws[i])
                            for i in range(3)])
        assert torch.equal(got, want)


BAD = ("party", "group", "seeds", "no queries", "keys", "rows", "dtype",
       "device", "queries", "sel rows", "layout", "sel dtype", "batch keys",
       "batch seeds")


def _bad(case):
    """(the error, a call that raises it) of one malformed input."""
    dpf, s0s, _, cws, db = _case(6, 3, 4, 5)
    s0, sel = s0s[:, 0], torch.zeros((65, 64), dtype=torch.int32)
    meta = torch.empty(db.shape, dtype=torch.int32, device="meta")
    return {
        "party": (ValueError, lambda: dpf.pir_answer(2, s0, cws, db)),
        "group": (ValueError, lambda: Dpf(6, groups.Uint(64), device="cpu")
                  .pir_answer(0, s0, cws, db)),
        "seeds": (ValueError, lambda: dpf.pir_answer(0, s0[0], cws, db)),
        "no queries": (ValueError, lambda: dpf.pir_answer(0, s0[:0],
                                                          cws[:0], db)),
        "keys": (ValueError, lambda: dpf.pir_answer(0, s0, cws[:2], db)),
        "rows": (ValueError, lambda: dpf.pir_answer(0, s0, cws, db[:32])),
        "dtype": (TypeError, lambda: dpf.pir_answer(0, s0, cws,
                                                    db.to(torch.int64))),
        "device": (ValueError, lambda: dpf.pir_answer(0, s0, cws, meta)),
        "queries": (ValueError, lambda: pir_cuda.contract(sel, db)),
        "sel rows": (ValueError, lambda: pir_cuda.contract(sel[:2, :32],
                                                           db)),
        "layout": (ValueError, lambda: pir_cuda.contract(
            sel[:2], db.t().contiguous().t())),
        "sel dtype": (TypeError, lambda: pir_cuda.contract(
            sel[:2].to(torch.int64), db)),
        "batch keys": (ValueError, lambda: eval_all_cuda.eval_all_batch(
            dpf.prg, dpf.group, 6, 0, s0, cws[:2])),
        "batch seeds": (ValueError, lambda: eval_all_cuda.eval_all_batch(
            dpf.prg, dpf.group, 6, 0, s0, cws)),  # s0: a strided view
    }[case]


@pytest.mark.parametrize("case", BAD)
def test_inputs_are_checked(case):
    error, call = _bad(case)
    with pytest.raises(error):
        call()
