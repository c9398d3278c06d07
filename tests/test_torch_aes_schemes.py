"""The port's DPF, DCF, Half-Tree DPF and VDPF with the AES-128-MMO PRG
against fss_tpu, byte-exact (tolerance 0: integer crypto), on the CPU.

The JAX side is each scheme's jitted XLA function with the AES table
backend (the default "auto" compiles the bitsliced circuit for batches of
256 and more: the same bits, a much longer compile). One jit a case
computes every party, group and entry point of it; XLA:CPU's compile is
most of this file's time, EvalAll's above all (a new shape a level), so
EvalAll is held against JAX at 1 bit here and at 8 and 16 bits by the
golden digests (test_torch_api.py, test_torch_half_tree.py,
test_torch_vdpf.py). The port's scheme is built from the JAX package's
configuration by ``interop`` and runs through its API with
``device="cpu"``, where each kernel wrapper takes its plain PyTorch
version. The AES Pallas kernels (B-14..B-18) are held against the same XLA
functions by tests/test_aes_pallas.py.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.hash import sha256 as jsh
from fss_tpu.prg.aes import Aes128Mmo
from fss_tpu.schemes import dcf as jdcf
from fss_tpu.schemes import dpf as jdpf
from fss_tpu.schemes import half_tree_dpf as jht
from fss_tpu.schemes import vdpf as jvdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import vdpf_cuda
from fss_tpu_torch.prg.aes import AesMmo
from torch_threads import one_torch_thread  # noqa: F401

# The JAX bench's AES keys (bench.py:225-226, 290-292).
KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
B = 32
GROUPS = {
    "bytes": None,
    "uint32": (32, 0),
    "uint127": (128, 1 << 127),
    "uint127m": (128, (1 << 127) - 1),
}
ALL = tuple(GROUPS)


def jprg(mul):
    return Aes128Mmo(mul, KEYS[:mul], backend="table")


def groups_pair(gname):
    spec = GROUPS[gname]
    if spec is None:
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(*spec), tgroups.Uint(*spec)


def _np(t):
    return tblk.to_numpy(t)


def _keys_inputs(rng, in_bits, below=False):
    """Seeds, betas, alphas and xs (as int lists): x = alpha on even keys;
    on odd ones another point, or for ``below`` (the DCF) a point below
    alpha where alpha > 0."""
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    alphas = [int(v) % (1 << in_bits) for v in rng.integers(0, 2**62,
                                                            size=B)]
    if below:
        xs = [a if i % 2 == 0 or a == 0 else int(rng.integers(0, a))
              for i, a in enumerate(alphas)]
    else:
        xs = [a if i % 2 == 0 else a ^ (1 << (i % in_bits))
              for i, a in enumerate(alphas)]
    return s0s, betas, alphas, xs


def _lanes(vals, in_bits):
    return _np(tblk.pack_inputs(vals, in_bits, "cpu"))


def _check_sum(tg, ys, betas, hit):
    """y0 + y1 is beta (clamped bit clear) where ``hit``, else 0."""
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    beta = tg.from_block(tblk.clear_lsb(interop.to_torch(betas, "cpu")))
    hit = torch.as_tensor(hit)
    assert torch.equal(rec, torch.where(hit[:, None], beta,
                                        torch.zeros_like(beta)))


def _roundtrip(cfg, prg, back, mul):
    """The configuration names the AES keys (no nonce, no backend), builds
    the port's AesMmo and reads back the same from the port's scheme."""
    assert cfg["prg"] == "aes" and "nonce" not in cfg
    assert "backend" not in cfg and back == cfg
    assert cfg["aes_keys"] == [k.hex() for k in KEYS[:mul]]
    assert prg == AesMmo(mul, KEYS[:mul])


@pytest.mark.parametrize("in_bits,gnames", [
    (1, ("bytes", "uint127m")), (8, ("uint32",)), (48, ("uint127",))])
def test_dpf_matches_xla(in_bits, gnames, rng):
    """Gen, Eval of both parties, and at 1 bit EvalAll of key 0 for both
    parties, for each group of the case; the JAX keys evaluate to the same
    shares in the port."""
    s0s, betas, alphas, xs = _keys_inputs(rng, in_bits)
    a_l, x_l = _lanes(alphas, in_bits), _lanes(xs, in_bits)
    full = in_bits == 1
    pairs = [groups_pair(g) for g in gnames]

    def jax_all(s, a, b, x):
        out = []
        for jg, _ in pairs:
            cws = jax.vmap(lambda s1, a1, b1: jdpf.gen(
                jprg(2), jg, in_bits, s1, a1, b1))(s, a, b)
            ys = [jdpf.eval_points(jprg(2), jg, in_bits, p, s[:, p], cws, x)
                  for p in (0, 1)]
            ea = [jdpf.eval_all(jprg(2), jg, in_bits, p, s[0, p], cws[0])
                  for p in (0, 1)] if full else []
            out.append((cws, ys, ea))
        return out

    want = jax.jit(jax_all)(jblk.block(s0s), a_l, jblk.block(betas), x_l)
    for (jg, tg), (wcws, wys, wea) in zip(pairs, want):
        cfg = interop.dpf_config(in_bits, jg, jprg(2))
        d = interop.dpf_from_config(cfg, device="cpu")
        _roundtrip(cfg, d.prg, interop.dpf_config(in_bits, d.group, d.prg),
                   2)
        cws = d.gen_batch(s0s, a_l, betas)
        assert np.array_equal(_np(cws), np.asarray(wcws))
        jcws = interop.to_torch(wcws, "cpu")
        ys = [d.eval(p, s0s[:, p], jcws, x_l) for p in (0, 1)]
        for y, w in zip(ys, wys):
            assert np.array_equal(_np(y), np.asarray(w))
        _check_sum(tg, ys, betas, [x == a for x, a in zip(xs, alphas)])
        for p, w in zip((0, 1), wea):
            assert np.array_equal(_np(d.eval_all(p, s0s[0, p], cws[0])),
                                  np.asarray(w))


@pytest.mark.parametrize("in_bits,gnames", [
    (1, ("bytes",)), (8, ("uint32", "uint127m")), (48, ("uint127",))])
def test_dcf_matches_xla(in_bits, gnames, rng):
    """Gen (lt), Eval of both parties, and at 1 bit EvalAll of key 0 for
    both parties, for each group of the case; the JAX keys evaluate to the
    same shares in the port."""
    s0s, betas, alphas, xs = _keys_inputs(rng, in_bits, below=True)
    a_l, x_l = _lanes(alphas, in_bits), _lanes(xs, in_bits)
    full = in_bits == 1
    pairs = [groups_pair(g) for g in gnames]

    def jax_all(s, a, b, x):
        out = []
        for jg, _ in pairs:
            cws = jax.vmap(lambda s1, a1, b1: jdcf.gen(
                jprg(4), jg, in_bits, "lt", s1, a1, b1))(s, a, b)
            ys = [jdcf.eval_points(jprg(4), jg, in_bits, "lt", p, s[:, p],
                                   cws, x) for p in (0, 1)]
            ea = [jdcf.eval_all(jprg(4), jg, in_bits, p, s[0, p], cws[0])
                  for p in (0, 1)] if full else []
            out.append((cws, ys, ea))
        return out

    want = jax.jit(jax_all)(jblk.block(s0s), a_l, jblk.block(betas), x_l)
    for (jg, tg), (wcws, wys, wea) in zip(pairs, want):
        cfg = interop.dcf_config(in_bits, jg, jprg(4), "lt")
        d = interop.dcf_from_config(cfg, device="cpu")
        _roundtrip(cfg, d.prg, interop.dcf_config(in_bits, d.group, d.prg,
                                                  d.pred), 4)
        cws = d.gen_batch(s0s, a_l, betas)
        assert np.array_equal(_np(cws), np.asarray(wcws))
        jcws = interop.to_torch(wcws, "cpu")
        ys = [d.eval(p, s0s[:, p], jcws, x_l) for p in (0, 1)]
        for y, w in zip(ys, wys):
            assert np.array_equal(_np(y), np.asarray(w))
        _check_sum(tg, ys, betas, [x < a for x, a in zip(xs, alphas)])
        for p, w in zip((0, 1), wea):
            assert np.array_equal(_np(d.eval_all(p, s0s[0, p], cws[0])),
                                  np.asarray(w))


def test_half_tree_matches_xla(rng):
    """Gen and Eval of both parties at 8 bits, AES-MMO mul=1 as the CCR
    hash with a random hash key; the JAX keys evaluate to the same shares
    in the port."""
    in_bits = 8
    jg, tg = groups_pair("uint32")
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    jhk = jax.numpy.asarray(hk)
    s0s, betas, alphas, xs = _keys_inputs(rng, in_bits)
    a_l, x_l = _lanes(alphas, in_bits), _lanes(xs, in_bits)

    def jax_all(s, a, b, x):
        cws, ocw = jax.vmap(lambda s1, a1, b1: jht.gen(
            jprg(1), jg, in_bits, jhk, s1, a1, b1))(s, a, b)
        return cws, ocw, [jht.eval_points(jprg(1), jg, in_bits, p, jhk,
                                          s[:, p], cws, ocw, x)
                          for p in (0, 1)]

    wcws, wocw, wys = jax.jit(jax_all)(jblk.block(s0s), a_l,
                                      jblk.block(betas), x_l)
    cfg = interop.half_tree_config(in_bits, jg, jprg(1), hk)
    d = interop.half_tree_from_config(cfg, device="cpu")
    _roundtrip(cfg, d.prg, interop.half_tree_config(
        in_bits, d.group, d.prg, d.hash_key), 1)
    cws, ocw = d.gen_batch(s0s, a_l, betas)
    assert np.array_equal(_np(cws), np.asarray(wcws))
    assert np.array_equal(_np(ocw), np.asarray(wocw))
    jkey = [interop.to_torch(k, "cpu") for k in (wcws, wocw)]
    ys = [d.eval(p, s0s[:, p], *jkey, x_l) for p in (0, 1)]
    for y, w in zip(ys, wys):
        assert np.array_equal(_np(y), np.asarray(w))
    _check_sum(tg, ys, betas, [x == a for x, a in zip(xs, alphas)])


def test_vdpf_matches_xla(rng):
    """Gen, Eval of both parties (shares and pi~), prove and verify at 8
    bits: AES-MMO mul=2 with SHA-256, the JAX bench's VDPF-AES
    configuration; the JAX keys evaluate to the same shares in the
    port."""
    in_bits = 8
    jg, tg = groups_pair("uint32")
    key = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    jh = jsh.Sha256(key)
    s0s, betas, alphas, xs = _keys_inputs(rng, in_bits)
    a_l, x_l = _lanes(alphas, in_bits), _lanes(xs, in_bits)

    def jax_all(s, a, b, x):
        cws, cs, ocw, fail = jax.vmap(lambda s1, a1, b1: jvdpf.gen(
            jprg(2), jh.xor_hash, jg, in_bits, s1, a1, b1))(s, a, b)
        return (cws, cs, ocw, fail), [
            jvdpf.eval_points(jprg(2), jh.xor_hash, jg, in_bits, p, s[:, p],
                              cws, cs, ocw, x) for p in (0, 1)]

    wkey, wys = jax.jit(jax_all)(jblk.block(s0s), a_l, jblk.block(betas),
                                 x_l)
    cfg = interop.vdpf_config(in_bits, jg, jprg(2), jh)
    d = interop.vdpf_from_config(cfg, device="cpu")
    _roundtrip(cfg, d.prg, interop.vdpf_config(in_bits, d.group, d.prg,
                                               d.hashes), 2)
    tkey = vdpf_cuda.gen_batch(d.prg, d.hashes, tg, in_bits,
                               interop.to_torch(s0s, "cpu"),
                               interop.to_torch(a_l, "cpu"),
                               interop.to_torch(betas, "cpu"))
    for g, w in zip(tkey, wkey):
        assert np.array_equal(_np(g), np.asarray(w))
    assert not tkey[3].any()
    jkey = [interop.to_torch(k, "cpu") for k in wkey[:3]]
    ys, pis = [], []
    for p, (wy, wpi) in zip((0, 1), wys):
        y, pi = d.eval(p, s0s[:, p], *jkey, x_l)
        assert np.array_equal(_np(y), np.asarray(wy))
        assert np.array_equal(_np(pi), np.asarray(wpi))
        ys.append(y)
        pis.append(pi)
    _check_sum(tg, ys, betas, [x == a for x, a in zip(xs, alphas)])
    assert torch.equal(pis[0], pis[1])
    cs0 = jkey[1][0]
    assert d.verify(d.prove(pis[0][:4], cs0), d.prove(pis[1][:4], cs0))
