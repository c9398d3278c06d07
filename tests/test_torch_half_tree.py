"""The port's Half-Tree DPF against fss_tpu, byte-exact (tolerance 0:
integer crypto), on the CPU.

The JAX side is ``fss_tpu.schemes.half_tree_dpf`` under ``jax.jit`` (the
JAX suite holds its Pallas kernels equal to that scheme,
tests/test_tree_kernels_pallas.py) and ``fss_tpu.api.HalfTreeDpf``; the
port runs its plain scheme and its kernel wrappers, which take their plain
PyTorch versions for CPU tensors. EvalAll is in
test_torch_half_tree_eval_all.py, and the Pallas kernels themselves, in
interpret mode, in test_torch_half_tree_kernels.py.
"""

import hashlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.api import HalfTreeDpf as JHalfTreeDpf
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import half_tree_dpf as jht
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.api import DEFAULT_NONCE, HalfTreeDpf
from fss_tpu_torch.ops import ht_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import half_tree_dpf as tht
from test_torch_api import golden_prg
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG1 = ChaCha(1, NONCE)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"

GROUPS = {
    "bytes": None,
    "uint32": (32, 0),
    "uint64": (64, 0),
    "uint127": (128, 1 << 127),
    "uint127m": (128, (1 << 127) - 1),
}

# Every case: ChaCha and AES-128-MMO.
_CASES = json.loads((VEC / "half_tree.json").read_text())["cases"]


def groups_pair(gname):
    spec = GROUPS[gname]
    if spec is None:
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(*spec), tgroups.Uint(*spec)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _np(t):
    return tblk.to_numpy(t)


def _check_point(tg, ys, betas, hit):
    """y0 + y1 is beta (clamped bit clear) where ``hit``, else 0."""
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    beta = tg.from_block(tblk.clear_lsb(betas))
    hit = torch.as_tensor(hit)
    assert torch.equal(rec, torch.where(hit[:, None], beta,
                                        torch.zeros_like(beta)))


@pytest.mark.parametrize("gname,in_bits", [
    ("bytes", 8), ("uint32", 1), ("uint64", 48), ("uint127", 2),
    ("uint127m", 8)])
def test_gen_and_eval_match_xla(gname, in_bits, rng):
    """Gen, and Eval of both parties with wire and broadcast keys, against
    the jitted JAX scheme; every group and every domain 1, 2, 8, 48."""
    B = 64
    jg, tg = groups_pair(gname)
    prg = JChaCha(1, NONCE)
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    jhk = jax.numpy.asarray(hk)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    alphas = [int(v) % (1 << in_bits) for v in rng.integers(0, 2**62,
                                                            size=B)]
    xs = [a if i % 2 == 0 else a ^ (1 << (i % in_bits))
          for i, a in enumerate(alphas)]
    a_lanes = tblk.pack_inputs(alphas, in_bits, "cpu")
    x_lanes = tblk.pack_inputs(xs, in_bits, "cpu")

    jcws, jocw = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda s, a, b: jht.gen(prg, jg, in_bits, jhk, s, a, b)))(
            jblk.block(s0s), _np(a_lanes), jblk.block(betas)))
    ts0s, tbetas = to_cpu(s0s), to_cpu(betas)
    cws, ocw = ht_cuda.gen_batch(PRG1, tg, in_bits, hk, ts0s, a_lanes,
                                 tbetas)
    assert cws.shape == (B, in_bits, 8) and ocw.shape == (B, 4)
    assert np.array_equal(_np(cws), jcws) and np.array_equal(_np(ocw), jocw)
    plain = tht.gen(ChaCha(1, NONCE), tg, in_bits, ht_cuda.hash_block(
        hk, "cpu"), ts0s, a_lanes, tbetas)
    assert torch.equal(plain[0], cws) and torch.equal(plain[1], ocw)

    jeval = jax.jit(lambda s, c, o, x: [
        jht.eval_points(prg, jg, in_bits, p, jhk, s[:, p], c, o, x)
        for p in (0, 1)])
    want = [np.asarray(y) for y in jeval(jblk.block(s0s), jcws, jocw,
                                         _np(x_lanes))]
    # One key broadcast over the batch: the JAX side sees it repeated.
    want1 = [np.asarray(y) for y in jeval(
        np.repeat(s0s[:1], B, axis=0), np.repeat(jcws[:1], B, axis=0),
        np.repeat(jocw[:1], B, axis=0), _np(x_lanes))]
    ys = []
    for party in (0, 1):
        s0 = ts0s[:, party].contiguous()
        got = ht_cuda.eval_points(PRG1, tg, in_bits, party, hk, s0, cws,
                                  ocw, x_lanes)
        assert np.array_equal(_np(got), want[party]), f"party {party}"
        assert torch.equal(got, tht.eval_points(
            ChaCha(1, NONCE), tg, in_bits, party,
            ht_cuda.hash_block(hk, "cpu"), s0, cws, ocw, x_lanes))
        one = ht_cuda.eval_points(PRG1, tg, in_bits, party, hk,
                                  s0[0].contiguous(), cws[0].contiguous(),
                                  ocw[0], x_lanes)
        assert np.array_equal(_np(one), want1[party]), f"party {party}"
        ys.append(got)
    _check_point(tg, ys, tbetas, [x == a for x, a in zip(xs, alphas)])


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def test_golden_case_count():
    assert len(_CASES) == 5


@pytest.mark.parametrize(
    "case", _CASES, ids=lambda c: f"{c['prg']}-{c['group']}-{c['in_bits']}")
def test_golden(case):
    g = {"bytes": tgroups.Bytes(), "uint64": tgroups.Uint(64)}[case["group"]]
    d = HalfTreeDpf(case["in_bits"], g, golden_prg(case, 1),
                    hash_key=_u32(case["hash_key"]), device="cpu")
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws, ocw = d.gen(s0s, int(case["alpha"], 0), _u32(case["beta"]))
    want = np.stack([_u32(r) for r in case["cws"]])
    assert _np(cws).tobytes() == want.tobytes(), "gen cws bytes"
    assert _np(ocw).tobytes() == bytes.fromhex(case["ocw"]), "gen ocw"
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys = d.eval(party, s0s[party], cws, ocw, xs)
        assert _np(ys).tobytes() == b"".join(bytes.fromhex(h)
                                             for h in case[f"ys{party}"])
        if "eval_all_digest0" in case:
            raw = _np(d.eval_all(party, s0s[party], cws, ocw)).tobytes()
            head = bytes.fromhex(case[f"eval_all_head{party}"])
            assert raw[:len(head)] == head
            assert hashlib.sha256(raw).hexdigest() == \
                case[f"eval_all_digest{party}"]


def test_slice_matches_jax_api(rng):
    """The JAX package's configuration crosses by
    interop.half_tree_config and its keys by interop.to_torch;
    gen_batch -> eval of both parties -> reconstruct gives beta at alpha
    and 0 elsewhere, every byte equal to fss_tpu.api.HalfTreeDpf's."""
    in_bits, B = 12, 200
    nonce = (0x0F0F0F0F, 0xF0F0F0F0)
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    jd = JHalfTreeDpf(in_bits, jgroups.Uint(32), JChaCha(1, nonce), hk)
    cfg = interop.half_tree_config(in_bits, jd.group, jd.prg, jd.hash_key)
    assert cfg == {"in_bits": in_bits, "group": "uint", "bits": 32, "mod": 0,
                   "nonce": list(nonce), "rounds": 20,
                   "hash_key": [int(w) for w in hk]}
    d = interop.half_tree_from_config(cfg, device="cpu")
    assert (d.in_bits, d.group, d.prg, d.hash_key) == (
        in_bits, tgroups.Uint(32), ChaCha(1, nonce), tuple(int(w) for w in hk))
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    xs = alphas.copy()
    xs[1::2] ^= rng.integers(1, 2**in_bits, size=B // 2, dtype=np.uint32)

    jcws, jocw = (np.asarray(a) for a in jd.gen_batch(
        jblk.block(s0s), alphas, jblk.block(betas)))
    cws, ocw = d.gen_batch(s0s, alphas, betas)
    assert np.array_equal(_np(cws), jcws) and np.array_equal(_np(ocw), jocw)
    keys = interop.to_torch(jcws, device="cpu"), interop.to_torch(
        jocw, device="cpu")
    ys = []
    for party in (0, 1):
        want = np.asarray(jd.eval(party, jblk.block(s0s[:, party]), jcws,
                                  jocw, xs))
        got = d.eval(party, s0s[:, party], *keys, xs)
        assert np.array_equal(_np(got), want), f"party {party}"
        ys.append(got)
    _check_point(d.group, ys, to_cpu(betas), xs == alphas)


def test_defaults_and_inputs(rng):
    d = HalfTreeDpf(16, device="cpu")
    assert d.prg == ChaCha(1, DEFAULT_NONCE) and d.group.name == "bytes"
    assert d.hash_key == (0, 0, 0, 0)
    assert HalfTreeDpf(16).device.type == "cuda"  # unless asked otherwise
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    cws, ocw = d.gen(s0s, 107, beta)
    assert cws.shape == (16, 8) and ocw.shape == (4,)
    assert cws.dtype == ocw.dtype == torch.int32
    xs = np.array([106, 107, 108], dtype=np.uint32)
    # ints, lists, numpy arrays and tensors are the same inputs
    a = d.eval(0, s0s[0], cws, ocw, xs)
    b = d.eval(0, torch.from_numpy(s0s[0].view(np.int32)), cws, ocw,
               [106, 107, 108])
    c = d.eval(0, s0s[0], cws, ocw, torch.tensor([106, 107, 108]))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(d.eval(0, s0s[0], cws, ocw, 107), a[1])
    rec = _np(a ^ d.eval(1, s0s[1], cws, ocw, xs))
    assert np.array_equal(rec[1], _np(tblk.clear_lsb(tblk.block(beta))))
    assert not rec[[0, 2]].any()
    with pytest.raises(ValueError):
        HalfTreeDpf(16, prg=ChaCha(2, DEFAULT_NONCE), device="cpu")
    with pytest.raises(ValueError):
        HalfTreeDpf(0, device="cpu")
    with pytest.raises(ValueError):
        HalfTreeDpf(16, hash_key=[1, 2, 3], device="cpu")


@pytest.mark.parametrize("group", [jgroups.Bytes(), jgroups.Uint(64),
                                   jgroups.Uint(128, (1 << 127) - 1)],
                         ids=lambda g: g.name)
def test_interop_config(group, rng):
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    prg = JChaCha(1, NONCE, 12)
    cfg = interop.half_tree_config(9, group, prg, jax.numpy.asarray(hk))
    json.dumps(cfg)  # plain values only
    d = interop.half_tree_from_config(cfg, device="cpu")
    assert d.in_bits == 9 and d.device.type == "cpu"
    assert d.prg == ChaCha(1, NONCE, 12) and d.group.name == group.name
    assert d.hash_key == tuple(int(w) for w in hk)
    assert interop.half_tree_config(9, d.group, d.prg, d.hash_key) == cfg
    # The card unless the caller asks for the CPU.
    assert interop.half_tree_from_config(cfg).device.type == "cuda"
