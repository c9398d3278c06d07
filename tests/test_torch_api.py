"""The port's ``Dpf`` and ``Dcf`` APIs: the reference's golden vectors and
the whole slice against ``fss_tpu.api``, byte-exact, on the CPU."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.api import Dcf as JDcf
from fss_tpu.api import Dpf as JDpf
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.api import DEFAULT_NONCE, Dcf, Dpf, PackedDpfKeys
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from torch_threads import one_torch_thread  # noqa: F401

VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"

# Every case: ChaCha and AES-128-MMO.
_DPF_CASES = json.loads((VEC / "dpf.json").read_text())["cases"]
_DCF_CASES = json.loads((VEC / "dcf.json").read_text())["cases"]


def golden_prg(case, mul):
    """The port's PRG of a golden case: AES-MMO with the case's first
    ``mul`` keys, or ChaCha with its nonce."""
    if case["prg"] == "aes":
        return AesMmo(mul, [bytes.fromhex(k) for k in case["aes_keys"][:mul]])
    return ChaCha(mul, (case["nonce_lo"], case["nonce_hi"]))


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def _group(name):
    return {"bytes": tgroups.Bytes(), "uint32": tgroups.Uint(32),
            "uint64": tgroups.Uint(64),
            "uint127": tgroups.Uint(128, mod=1 << 127),
            "uint127m": tgroups.Uint(128, mod=(1 << 127) - 1)}[name]


def _bytes(t):
    return tblk.to_numpy(t).tobytes()


@pytest.mark.parametrize(
    "case", _DPF_CASES,
    ids=lambda c: f"{c['prg']}-{c['group']}-{c['in_bits']}")
def test_dpf_golden(case):
    n = case["in_bits"]
    d = Dpf(n, group=_group(case["group"]),
            prg=golden_prg(case, 2),
            device="cpu")
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0), _u32(case["beta"]))
    want = np.stack([_u32(r) for r in case["cws"]])
    assert _bytes(cws) == want.tobytes(), "gen cws bytes"
    for i, x_h in enumerate(case["xs"]):
        x = int(x_h, 0)
        for party in (0, 1):
            y = d.eval(party, s0s[party], cws, [x])
            assert _bytes(y[0]) == bytes.fromhex(case[f"ys{party}"][i]), \
                f"party{party} x={x_h}"
    if "eval_all_digest0" in case:
        for party in (0, 1):
            raw = _bytes(d.eval_all(party, s0s[party], cws))
            head = bytes.fromhex(case[f"eval_all_head{party}"])
            assert raw[:len(head)] == head
            assert hashlib.sha256(raw).hexdigest() == \
                case[f"eval_all_digest{party}"]


@pytest.mark.parametrize("layout", ["wire", "packed"])
def test_slice_matches_jax_api(layout, rng):
    """gen_batch -> eval for both parties -> reconstruct: beta at alpha,
    zero elsewhere, and every byte equal to fss_tpu.api.Dpf's."""
    in_bits, B = 12, 300
    nonce = (0x0F0F0F0F, 0xF0F0F0F0)
    jd = JDpf(in_bits, jgroups.Uint(32), JChaCha(2, nonce))
    cfg = interop.dpf_config(in_bits, jd.group, jd.prg)
    d = interop.dpf_from_config(cfg, device="cpu")
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    xs = alphas.copy()
    xs[1::2] ^= rng.integers(1, 2**in_bits, size=B // 2, dtype=np.uint32)

    jcws = np.asarray(jd.gen_batch(jblk.block(s0s), alphas,
                                   jblk.block(betas)))
    keys = d.gen_batch(s0s, alphas, betas, layout=layout)
    wire = keys.to_wire(in_bits) if layout == "packed" else keys
    assert isinstance(keys, PackedDpfKeys) == (layout == "packed")
    assert np.array_equal(tblk.to_numpy(wire), jcws)

    ys = []
    for party in (0, 1):
        want = np.asarray(jd.eval(party, jblk.block(s0s[:, party]), jcws,
                                  xs))
        got = d.eval(party, s0s[:, party], keys, xs)
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        ys.append(got)
    g = d.group
    rec = tblk.to_numpy(g.add(g.from_block(ys[0]), g.from_block(ys[1])))
    assert np.array_equal(rec[0::2, 0], betas[0::2, 0])
    assert not rec[1::2].any() and not rec[:, 1:].any()


def test_dpf_defaults_and_inputs(rng):
    d = Dpf(16, device="cpu")
    assert d.prg == ChaCha(2, DEFAULT_NONCE) and d.group.name == "bytes"
    assert Dpf(16).device.type == "cuda"  # the card unless asked otherwise
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    cws = d.gen(s0s, 107, beta)
    assert cws.shape == (17, 8) and cws.dtype == torch.int32
    xs = np.array([106, 107, 108], dtype=np.uint32)
    # ints, lists, numpy arrays and tensors are the same inputs
    a = d.eval(0, s0s[0], cws, xs)
    b = d.eval(0, torch.from_numpy(s0s[0].view(np.int32)), cws,
               [106, 107, 108])
    c = d.eval(0, s0s[0], cws, torch.tensor([106, 107, 108]))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(d.eval(0, s0s[0], cws, 107), a[1])
    y1 = d.eval(1, s0s[1], cws, xs)
    assert np.array_equal(tblk.to_numpy(a ^ y1)[1],
                          tblk.to_numpy(tblk.clear_lsb(tblk.block(beta))))
    assert not tblk.to_numpy(a ^ y1)[[0, 2]].any()
    with pytest.raises(ValueError):
        Dpf(16, prg=ChaCha(4, DEFAULT_NONCE), device="cpu")
    with pytest.raises(ValueError):
        d.gen_batch(s0s[None], [1], beta[None], layout="rows")


def test_dcf_golden_case_count():
    assert len(_DCF_CASES) == 7


@pytest.mark.parametrize(
    "case", _DCF_CASES,
    ids=lambda c: f"{c['prg']}-{c['group']}-{c['in_bits']}-{c['pred']}")
def test_dcf_golden(case):
    n = case["in_bits"]
    d = Dcf(n, group=_group(case["group"]),
            prg=golden_prg(case, 4),
            pred=case["pred"], device="cpu")
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0), _u32(case["beta"]))
    want = np.stack([_u32(r) for r in case["cws"]])
    assert _bytes(cws) == want.tobytes(), "gen cws bytes"
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        ys = d.eval(party, s0s[party], cws, xs)
        assert _bytes(ys) == b"".join(bytes.fromhex(h)
                                      for h in case[f"ys{party}"])
    if "eval_all_digest0" in case:
        for party in (0, 1):
            raw = _bytes(d.eval_all(party, s0s[party], cws))
            head = bytes.fromhex(case[f"eval_all_head{party}"])
            assert raw[:len(head)] == head
            assert hashlib.sha256(raw).hexdigest() == \
                case[f"eval_all_digest{party}"]


@pytest.mark.parametrize("pred", ["lt", "gt"])
def test_dcf_slice_matches_jax_api(pred, rng):
    """The JAX package's keys cross by interop.to_torch and its
    configuration by interop.dcf_config; gen_batch -> eval of both
    parties -> reconstruct gives beta on the predicate's side of alpha,
    and every byte equal to fss_tpu.api.Dcf's."""
    in_bits, B = 10, 200
    nonce = (0x0F0F0F0F, 0xF0F0F0F0)
    jd = JDcf(in_bits, jgroups.Uint(64, (1 << 61) - 1), JChaCha(4, nonce),
              pred=pred)
    cfg = interop.dcf_config(in_bits, jd.group, jd.prg, jd.pred)
    assert cfg == {"in_bits": in_bits, "group": "uint", "bits": 64,
                   "mod": (1 << 61) - 1, "nonce": list(nonce),
                   "rounds": 20, "pred": pred}
    d = interop.dcf_from_config(cfg, device="cpu")
    assert (d.in_bits, d.group, d.prg, d.pred) == (
        in_bits, tgroups.Uint(64, (1 << 61) - 1), ChaCha(4, nonce), pred)
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    xs = ((alphas.astype(np.int64) + rng.integers(-2, 3, size=B))
          % (1 << in_bits)).astype(np.uint32)

    jcws = np.asarray(jd.gen_batch(jblk.block(s0s), alphas,
                                   jblk.block(betas)))
    cws = d.gen_batch(s0s, alphas, betas)
    assert np.array_equal(tblk.to_numpy(cws), jcws)
    jkeys = interop.to_torch(jcws, device="cpu")
    ys = []
    for party in (0, 1):
        want = np.asarray(jd.eval(party, jblk.block(s0s[:, party]), jcws,
                                  xs))
        got = d.eval(party, s0s[:, party], jkeys, xs)
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        ys.append(got)
    g = d.group
    rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))
    beta = g.from_block(tblk.clear_lsb(tblk.block(betas)))
    hit = torch.from_numpy(xs < alphas if pred == "lt" else xs > alphas)
    assert torch.equal(rec, torch.where(hit[:, None], beta,
                                        torch.zeros_like(beta)))


def test_dcf_defaults_and_inputs(rng):
    d = Dcf(12, device="cpu")
    assert d.prg == ChaCha(4, DEFAULT_NONCE) and d.group.name == "bytes"
    assert d.pred == "lt"
    assert Dcf(12).device.type == "cuda"  # the card unless asked otherwise
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(4,), dtype=np.uint32)
    cws = d.gen(s0s, 1000, beta)
    assert cws.shape == (13, 8) and cws.dtype == torch.int32
    xs = np.array([999, 1000, 1001], dtype=np.uint32)
    # ints, lists, numpy arrays and tensors are the same inputs
    a = d.eval(0, s0s[0], cws, xs)
    b = d.eval(0, torch.from_numpy(s0s[0].view(np.int32)), cws,
               [999, 1000, 1001])
    c = d.eval(0, s0s[0], cws, torch.tensor([999, 1000, 1001]))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(d.eval(0, s0s[0], cws, 999), a[0])
    rec = tblk.to_numpy(a ^ d.eval(1, s0s[1], cws, xs))
    assert np.array_equal(rec[0],
                          tblk.to_numpy(tblk.clear_lsb(tblk.block(beta))))
    assert not rec[1:].any()
    with pytest.raises(ValueError):
        Dcf(12, prg=ChaCha(2, DEFAULT_NONCE), device="cpu")
    with pytest.raises(ValueError):
        Dcf(12, pred="le", device="cpu")
    with pytest.raises(ValueError):
        Dcf(0, device="cpu")
