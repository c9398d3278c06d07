"""The yardstick's reference against the golden vectors of the upstream
construction (``tests/golden/vectors/dcf.json``, ``dpf.json``): every
ChaCha case whose group it implements (16 bytes, Uint of up to 64 bits)."""

import hashlib
import json

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import tree

VEC = harness.ROOT / "tests" / "golden" / "vectors"
GROUPS = ("bytes", "uint32", "uint64")


def _cases(name):
    return [c for c in json.loads((VEC / name).read_text())["cases"]
            if c["prg"] == "chacha" and c["group"] in GROUPS]


def _words(h):
    return torch.from_numpy(np.frombuffer(bytes.fromhex(h), "<u4")
                            .astype(np.int64))


def _lanes(value: int):
    return torch.tensor([[(value >> (32 * i)) & tree.MASK
                          for i in range(4)]], dtype=torch.int64)


def _hex(t):
    return t.to(torch.int64).numpy().astype("<u4").tobytes().hex()


def _raw(t):
    return t.numpy().astype("<u4").tobytes()


def _setup(case):
    s0s = torch.stack([_words(h) for h in case["s0s"]])[None]
    nonce = (case["nonce_lo"], case["nonce_hi"])
    return s0s, nonce, tree.Group(case["group"])


@pytest.mark.parametrize("case", _cases("dpf.json"),
                         ids=lambda c: f"{c['group']}-{c['in_bits']}")
def test_dpf_golden(case):
    s0s, nonce, group = _setup(case)
    n = case["in_bits"]
    cws = tree.dpf_gen(nonce, 20, group, n, s0s,
                       _lanes(int(case["alpha"], 0)),
                       _words(case["beta"])[None])[0]
    assert [_hex(r) for r in cws] == case["cws"]
    if "eval_all_digest0" in case:
        for p in (0, 1):
            raw = _raw(tree.dpf_eval_all(nonce, 20, group, n, p,
                                         s0s[0, p], cws))
            assert hashlib.sha256(raw).hexdigest() == \
                case[f"eval_all_digest{p}"]


@pytest.mark.parametrize("case", _cases("dcf.json"),
                         ids=lambda c: f"{c['group']}-{c['in_bits']}-"
                                       f"{c['pred']}")
def test_dcf_golden(case):
    s0s, nonce, group = _setup(case)
    n = case["in_bits"]
    cws = tree.dcf_gen(nonce, 20, group, n, case["pred"], s0s,
                       _lanes(int(case["alpha"], 0)),
                       _words(case["beta"])[None])
    assert [_hex(r) for r in cws[0]] == case["cws"]
    xs = torch.cat([_lanes(int(x, 0)) for x in case["xs"]])
    B = xs.shape[0]
    for p in (0, 1):
        ys = tree.dcf_eval(nonce, 20, group, n, p,
                           s0s[0, p].expand(B, 4), cws.expand(B, -1, -1),
                           xs)
        assert [_hex(y) for y in ys] == case[f"ys{p}"]


def test_dpf_eval_all_reconstructs_the_point():
    """The two parties' EvalAll shares sum to beta at alpha, 0 elsewhere."""
    case = [c for c in _cases("dpf.json") if c["group"] == "uint32"][0]
    s0s, nonce, group = _setup(case)
    n = case["in_bits"]
    alpha = int(case["alpha"], 0)
    cws = tree.dpf_gen(nonce, 20, group, n, s0s, _lanes(alpha),
                       torch.tensor([[7, 0, 0, 0]]))[0]
    ys = [tree.dpf_eval_all(nonce, 20, group, n, p, s0s[0, p], cws)
          for p in (0, 1)]
    rec = (ys[0][:, 0] + ys[1][:, 0]) & tree.MASK
    assert int(rec[alpha]) == 7 and int(rec.sum()) == 7
