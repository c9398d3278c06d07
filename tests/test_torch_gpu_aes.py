"""The AES-128-MMO instantiations of the port's CUDA kernels against their
plain PyTorch versions on the card, and the AES golden vectors there.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import). Every kernel call runs with the
wrapper module's plain versions replaced by a stub that raises, and the
launch counts show the AES instantiation ran (``<source>_aes``) and the
ChaCha one did not. The file imports no JAX, so on a machine without it
run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_aes.py
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
from fss_tpu_torch.api import Dcf, Dpf, HalfTreeDpf, Vdpf
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import (dcf_cuda, dpf_cuda, eval_all_cuda, ht_cuda,
                               vdpf_cuda)
from fss_tpu_torch.prg.aes import AesMmo

pytestmark = pytest.mark.gpu

KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
PRG = {m: AesMmo(m, KEYS[:m]) for m in (1, 2, 4)}
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"
BATCH = 1000
DCF_GROUPS = {"xor": groups.Bytes(), "wrap": groups.Uint(32),
              "mod64": groups.Uint(64, (1 << 61) - 1),
              "mod128": groups.Uint(128, 1 << 127),
              "mod128np": groups.Uint(128, (1 << 127) - 1)}
MODULES = (dpf_cuda, dcf_cuda, ht_cuda, vdpf_cuda, eval_all_cuda)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernels_only(monkeypatch):
    """Replace every plain version of the wrapper modules by a stub that
    raises, and zero the launch counts; returns the counts."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached a plain version")
    for mod in MODULES:
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, refuse)
    _build.reset_launches()
    return _build.launches


def _aes_only(launches, *sources):
    assert all(launches[f"{s}_aes"] > 0 for s in sources), launches
    assert not any(launches[s] for s in _build.PRG_SOURCES), launches


def _words(rng, shape, dev, bits=32):
    return blk.words(rng.integers(0, 2**bits, size=shape, dtype=np.uint64),
                     dev)


def _inputs(rng, n, batch, dev):
    """Alpha (or x) values below 2^n in the kernels' layout."""
    if n <= 32:
        return _words(rng, (batch,), dev, n)
    vals = [int(v) % (1 << n) for v in rng.integers(0, 2**63, size=batch)]
    return blk.pack_inputs(vals, n, dev)


def _flip(xs, batch):
    out = xs.clone()
    out.view(batch, -1)[1::2, 0] ^= 1
    return out


@pytest.mark.parametrize("layout", ["wire", "packed", "broadcast"])
@pytest.mark.parametrize("n", [16, 48])
def test_dpf_eval(n, layout, cuda, monkeypatch):
    rng = np.random.default_rng(n)
    s0s = _words(rng, (BATCH, 2, 4), cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    wire = dpf_cuda.gen_batch(PRG[2], groups.Bytes(), n, s0s, alphas,
                              _words(rng, (BATCH, 4), cuda))
    xs = _flip(alphas, BATCH)
    s0, cws, packed = {
        "wire": (s0s[:, 0].contiguous(), wire, False),
        "packed": (s0s[:, 0].contiguous(), dpf_cuda.pack_keys(wire, n)[0],
                   True),
        "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous(), False),
    }[layout]
    want = [dpf_cuda.eval_packed_plain(s0, cws, xs, n, p, PRG[2],
                                       packed=packed) for p in (0, 1)]
    launches = kernels_only(monkeypatch)
    for party in (0, 1):
        got = dpf_cuda.eval_packed(s0, cws, xs, n, party, PRG[2],
                                   packed=packed)
        assert all(torch.equal(a, b) for a, b in zip(got, want[party]))
    _aes_only(launches, "dpf_eval")


@pytest.mark.parametrize("layout", ["wire", "packed", "vdpf"])
@pytest.mark.parametrize("n", [16, 48])
def test_dpf_gen(n, layout, cuda, monkeypatch):
    rng = np.random.default_rng(100 + n)
    s0s = _words(rng, (BATCH, 2, 4), cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    kw = ({"layout": "wire", "ocw_row": False} if layout == "vdpf"
          else {"layout": layout})
    want = dpf_cuda.gen_packed_plain(s0s, alphas, n, PRG[2], **kw)
    launches = kernels_only(monkeypatch)
    got = dpf_cuda.gen_packed(s0s, alphas, n, PRG[2], **kw)
    if layout == "packed":  # (planes, ocw): the ocw zero without betas
        assert not got[0][1].any()
        got, want = (*got[0], *got[1:]), (*want[0], *want[1:])
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    _aes_only(launches, "dpf_gen")


@pytest.mark.parametrize("layout", ["wire", "packed"])
@pytest.mark.parametrize("n", [1, 16, 128])
def test_dpf_gen_output_cw(n, layout, cuda, monkeypatch):
    """B-17 given betas and the group: the output CW in the kernel, every
    group kind, against the plain version."""
    rng = np.random.default_rng(150 + n)
    s0s, betas = _words(rng, (BATCH, 2, 4), cuda), _words(rng, (BATCH, 4),
                                                          cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    want = {m: dpf_cuda.gen_packed_plain(s0s, alphas, n, PRG[2], layout,
                                         betas=betas, group=g)
            for m, g in DCF_GROUPS.items()}
    launches = kernels_only(monkeypatch)
    for m, g in DCF_GROUPS.items():
        got = dpf_cuda.gen_packed(s0s, alphas, n, PRG[2], layout,
                                  betas=betas, group=g)
        flat = [*got[0], *got[1:]] if layout == "packed" else got
        ref = [*want[m][0], *want[m][1:]] if layout == "packed" else want[m]
        assert all(torch.equal(a, b) for a, b in zip(flat, ref)), m
    _aes_only(launches, "dpf_gen")


@pytest.mark.parametrize("mode", list(DCF_GROUPS))
@pytest.mark.parametrize("n", [1, 16, 128])
def test_dcf_gen(n, mode, cuda, monkeypatch):
    """B-18 in every mode, lt and gt, alpha as 1 lane (n <= 32) and as 4,
    against its plain version."""
    rng = np.random.default_rng(400 + n)
    g = DCF_GROUPS[mode]
    s0s, betas = _words(rng, (BATCH, 2, 4), cuda), _words(rng, (BATCH, 4),
                                                          cuda)
    lanes = blk.pack_inputs([int(v) % (1 << n) for v in rng.integers(
        0, 2**63, size=BATCH)], n, cuda)
    alphas = [lanes] + ([lanes[:, 0].contiguous()] if n <= 32 else [])
    want = {(i, p): dcf_cuda.gen_packed_plain(s0s, a, betas, n, PRG[4], p, g)
            for i, a in enumerate(alphas) for p in ("lt", "gt")}
    launches = kernels_only(monkeypatch)
    for (i, p), w in want.items():
        assert torch.equal(dcf_cuda.gen_packed(s0s, alphas[i], betas, n,
                                               PRG[4], p, g), w), (i, p)
    _aes_only(launches, "dcf_gen")


@pytest.mark.parametrize("mode", list(DCF_GROUPS))
@pytest.mark.parametrize("n", [16, 48])
def test_dcf_eval_and_gen(n, mode, cuda, monkeypatch):
    """The eval kernel in each accumulator mode (wire and broadcast keys),
    and the gen kernel for the mode's group, lt and gt."""
    rng = np.random.default_rng(300 + n)
    g = DCF_GROUPS[mode]
    vmask = dcf_cuda.value_mask(g)
    s0s, betas = _words(rng, (BATCH, 2, 4), cuda), _words(rng, (BATCH, 4),
                                                          cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    xs = _flip(alphas, BATCH)
    gens = {p: dcf_cuda.gen_packed_plain(s0s, alphas, betas, n, PRG[4], p, g)
            for p in ("lt", "gt")}
    cases = [(s0s[:, 1].contiguous(), gens["lt"]),
             (s0s[0, 1].contiguous(), gens["lt"][0].contiguous())]
    evals = [dcf_cuda.eval_packed_plain(s0, c, xs, n, 1, PRG[4], mode, vmask)
             for s0, c in cases]
    launches = kernels_only(monkeypatch)
    for pred, want in gens.items():
        assert torch.equal(dcf_cuda.gen_packed(s0s, alphas, betas, n, PRG[4],
                                               pred, g), want)
    for (s0, c), want in zip(cases, evals):
        got = dcf_cuda.eval_packed(s0, c, xs, n, 1, PRG[4], mode, vmask)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _aes_only(launches, "dcf_eval", "dcf_gen")


@pytest.mark.parametrize("n", [1, 16, 48])
def test_half_tree_eval_and_gen(n, cuda, monkeypatch):
    rng = np.random.default_rng(400 + n)
    hk = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    s0s = _words(rng, (BATCH, 2, 4), cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    xs = _flip(alphas, BATCH)
    keys = ht_cuda.gen_packed_plain(s0s, alphas, n, PRG[1], hk)
    evals = [ht_cuda.eval_packed_plain(s0s[:, p].contiguous(), keys[0], xs,
                                       n, p, PRG[1], hk) for p in (0, 1)]
    launches = kernels_only(monkeypatch)
    got = ht_cuda.gen_packed(s0s, alphas, n, PRG[1], hk)
    assert all(torch.equal(a, b) for a, b in zip(got, keys))
    for p in (0, 1):
        got = ht_cuda.eval_packed(s0s[:, p].contiguous(), keys[0], xs, n, p,
                                  PRG[1], hk)
        assert all(torch.equal(a, b) for a, b in zip(got, evals[p]))
    _aes_only(launches, "ht_eval", "ht_gen")


@pytest.mark.parametrize("hname", ["blake3", "sha256"])
@pytest.mark.parametrize("n", [16, 48])
def test_vdpf_eval(n, hname, cuda, monkeypatch):
    rng = np.random.default_rng(500 + n)
    hashes = (Blake3(tuple(int(w) for w in rng.integers(0, 2**32, size=8)))
              if hname == "blake3" else
              Sha256(tuple(int(w) for w in rng.integers(0, 2**32, size=4))))
    s0s = _words(rng, (BATCH, 2, 4), cuda)
    alphas = _inputs(rng, n, BATCH, cuda)
    xs = _flip(alphas, BATCH)
    cws = dpf_cuda.gen_packed_plain(s0s, alphas, n, PRG[2],
                                    ocw_row=False)[0]
    want = [vdpf_cuda.eval_packed_plain(s0s[:, p].contiguous(), cws, xs, n,
                                        p, PRG[2], hashes) for p in (0, 1)]
    launches = kernels_only(monkeypatch)
    for p in (0, 1):
        got = vdpf_cuda.eval_packed(s0s[:, p].contiguous(), cws, xs, n, p,
                                    PRG[2], hashes)
        assert all(torch.equal(a, b) for a, b in zip(got, want[p]))
    _aes_only(launches, "vdpf_eval")


@pytest.mark.parametrize("n", [1, 8, 16])
def test_eval_all_expansions(n, cuda, monkeypatch):
    """The three EvalAll kernels, one key a scheme, both parties: the DPF's
    shares and its seeds epilogue, the DCF in its wrap and mod128np modes,
    the Half-Tree's shares (each on the default plan and with subtrees of
    at most 2 levels)."""
    rng = np.random.default_rng(600 + n)
    hk = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    s0s = _words(rng, (1, 2, 4), cuda)
    alpha = _inputs(rng, n, 1, cuda)
    beta = _words(rng, (1, 4), cuda)
    g = groups.Uint(32)
    dpf_key = dpf_cuda.gen_batch(PRG[2], g, n, s0s, alpha, beta)[0]
    dcf_keys = {m: dcf_cuda.gen_packed(s0s, alpha, beta, n, PRG[4], "lt",
                                       DCF_GROUPS[m])[0]
                for m in ("wrap", "mod128np")}
    ht_cws, ht_ocw = (k[0] for k in ht_cuda.gen_batch(PRG[1], g, n, hk, s0s,
                                                      alpha, beta))
    E = eval_all_cuda

    def expand_all(dpf_all, dpf_leaves, dcf_all, ht_all):
        out = []
        for p in (0, 1):
            s0 = s0s[0, p]
            for most in (E.SUBTREE_LEVELS, 2):
                out.append(dpf_all(PRG[2], g, n, p, s0, dpf_key, most))
                out.append(dpf_leaves(PRG[2], n, p, s0, dpf_key, most))
                for m, key in dcf_keys.items():
                    out.append(dcf_all(PRG[4], DCF_GROUPS[m], n, p, s0, key,
                                       most))
                out.append(ht_all(PRG[1], g, n, p, hk, s0, ht_cws, ht_ocw,
                                  most))
        return out

    want = expand_all(E.eval_all_plain, E.expand_leaves_plain,
                      E.dcf_eval_all_plain, E.ht_eval_all_plain)
    launches = kernels_only(monkeypatch)
    got = expand_all(E.eval_all, E.expand_leaves, E.dcf_eval_all,
                     E.ht_eval_all)
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)
    _aes_only(launches, "dpf_eval_all", "dcf_eval_all", "ht_eval_all")


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def _case_prg(case, mul):
    return AesMmo(mul, [bytes.fromhex(k) for k in case["aes_keys"][:mul]])


@pytest.mark.parametrize("scheme", ["dpf", "dcf", "half_tree", "vdpf"])
def test_golden_on_the_card(scheme, cuda, monkeypatch):
    """The AES golden cases through the API on the card: Gen bytes, the
    shares of both parties, EvalAll digests; the VDPF's pi~, proofs and
    reference-fold EvalAll proof."""
    gmap = {"bytes": groups.Bytes(), "uint64": groups.Uint(64)}
    cases = [c for c in json.loads((VEC / f"{scheme}.json").read_text())
             ["cases"] if c["prg"] == "aes"]
    assert cases
    launches = kernels_only(monkeypatch)
    for case in cases:
        n, g = case["in_bits"], gmap[case["group"]]
        s0s = np.stack([_u32(h) for h in case["s0s"]])
        alpha, beta = int(case["alpha"], 0), _u32(case["beta"])
        xs = [int(x, 0) for x in case["xs"]]
        if scheme == "vdpf":
            d = Vdpf(n, g, _case_prg(case, 2),
                     hashes=Sha256(_u32(case["hash_key"])))
            cws, cs, ocw, fail = d.gen(s0s, alpha, beta)
            key = (cws, cs, ocw)
            assert not int(fail)
            assert blk.to_numpy(cs).tobytes() == b"".join(
                bytes.fromhex(h) for h in case["cs"])
        elif scheme == "half_tree":
            d = HalfTreeDpf(n, g, _case_prg(case, 1), _u32(case["hash_key"]))
            key = d.gen(s0s, alpha, beta)
        else:
            d = (Dpf(n, g, _case_prg(case, 2)) if scheme == "dpf"
                 else Dcf(n, g, _case_prg(case, 4), case["pred"]))
            key = (d.gen(s0s, alpha, beta),)
        assert blk.to_numpy(key[0]).tobytes() == np.stack(
            [_u32(r) for r in case["cws"]]).tobytes()
        for p in (0, 1):
            out = d.eval(p, s0s[p], *key, xs)
            ys = out[0] if scheme == "vdpf" else out
            assert blk.to_numpy(ys).tobytes() == b"".join(
                bytes.fromhex(h) for h in case[f"ys{p}"])
            full = d.eval_all(p, s0s[p], *key)
            if scheme == "vdpf":
                assert blk.to_numpy(out[1]).tobytes() == b"".join(
                    bytes.fromhex(h) for h in case[f"pi_tildes{p}"])
                assert blk.to_numpy(d.prove(out[1], key[1])).tobytes() == \
                    bytes.fromhex(case[f"prove_pi{p}"])
                assert blk.to_numpy(full[1]).tobytes() == bytes.fromhex(
                    case[f"eval_all_pi{p}"])
                full = full[0]
            assert hashlib.sha256(blk.to_numpy(full).tobytes()).hexdigest() \
                == case[f"eval_all_digest{p}"]
    sources = {"dpf": ("dpf_gen", "dpf_eval", "dpf_eval_all"),
               "dcf": ("dcf_gen", "dcf_eval", "dcf_eval_all"),
               "half_tree": ("ht_gen", "ht_eval", "ht_eval_all"),
               "vdpf": ("dpf_gen", "vdpf_eval", "dpf_eval_all")}[scheme]
    _aes_only(launches, *sources)
