"""The port's VDPF full-domain evaluation against fss_tpu, byte-exact
(tolerance 0: integer crypto), on the CPU: shares and proofs of both
parties with each of the three folds, each group, both hashes, up to 10
bits.

The JAX side is ``fss_tpu.schemes.vdpf.eval_all`` (the reference fold)
and ``fss_tpu.ops.eval_all_pallas.vdpf_eval_all_chunked`` (the tree and
chunked folds) under ``jax.jit``; the port runs
``eval_all_cuda.vdpf_eval_all``, whose kernel wrappers take their plain
PyTorch versions for CPU tensors, and its plain scheme.
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu.ops import eval_all_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import vdpf as jvdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch.ops import eval_all_cuda, vdpf_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import vdpf as tvdpf
from test_torch_vdpf import NONCE, PRG2, groups_pair, hashes_pair, to_cpu
from torch_threads import one_torch_thread  # noqa: F401


def _jax_eval_all(jh, jg, in_bits, fold):
    """Party 0's EvalAll in fss_tpu with fold ``fold``, jitted."""
    prg = JChaCha(2, NONCE)
    if fold == "reference":
        return jax.jit(lambda s, c, k, o: jvdpf.eval_all(
            prg, jh.xor_hash, jh.hash64, jg, in_bits, 0, s, c, k, o))
    return jax.jit(lambda s, c, k, o: eval_all_pallas.vdpf_eval_all_chunked(
        prg, jh.xor_hash, jh.hash64, jg, in_bits, 0, s, c, k, o, fold=fold))


@pytest.mark.parametrize("gname,in_bits,hname,fold", [
    ("uint32", 10, "blake3", "reference"), ("bytes", 9, "blake3", "chunked"),
    ("uint64", 10, "sha256", "tree"), ("uint127", 6, "sha256", "reference"),
    ("uint127m", 1, "blake3", "tree"), ("uint32", 3, "sha256", "chunked")])
def test_eval_all_matches_xla(gname, in_bits, hname, fold, rng):
    """Party 0's shares and proof against fss_tpu (one JAX compile a
    case); the two parties' shares reconstruct to beta at alpha and 0
    elsewhere and their proofs are equal, so party 1's bytes are the
    JAX package's too; the plain scheme gives the same bytes."""
    jg, tg = groups_pair(gname)
    jh, th = hashes_pair(hname, rng)
    s0s = rng.integers(0, 2**32, size=(1, 2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=(1, 4), dtype=np.uint32)
    alpha = int(rng.integers(0, 2**in_bits))
    cws, cs, ocw, _ = (t[0] for t in vdpf_cuda.gen_batch(
        PRG2, th, tg, in_bits, to_cpu(s0s), to_cpu([alpha]), to_cpu(beta)))
    wy, wpi = _jax_eval_all(jh, jg, in_bits, fold)(
        jblk.block(s0s[0, 0]), tblk.to_numpy(cws), tblk.to_numpy(cs),
        tblk.to_numpy(ocw))
    ys, pis = [], []
    for party in (0, 1):
        s0 = to_cpu(s0s[0, party])
        y, pi = eval_all_cuda.vdpf_eval_all(ChaCha(2, NONCE), th, tg,
                                            in_bits, party, s0, cws, cs, ocw,
                                            fold)
        if party == 0:
            assert np.array_equal(tblk.to_numpy(y), np.asarray(wy))
            assert np.array_equal(tblk.to_numpy(pi), np.asarray(wpi))
        py, ppi = tvdpf.eval_all(ChaCha(2, NONCE), th.xor_hash, th.hash64, tg,
                                 in_bits, party, s0, cws, cs, ocw, fold)
        assert torch.equal(py, y) and torch.equal(ppi, pi)
        ys.append(y)
        pis.append(pi)
    rec = tg.add(tg.from_block(ys[0]), tg.from_block(ys[1]))
    want = torch.zeros_like(rec)
    want[alpha] = tg.from_block(tblk.clear_lsb(to_cpu(beta[0])))
    assert torch.equal(rec, want)
    assert tvdpf.verify(*pis)


def test_folds_differ_and_match_the_scheme(rng):
    """The three folds of one pi~ batch give three different proofs, each
    equal to the plain scheme's; the tree proof ends with cs[2:4]."""
    _, th = hashes_pair("blake3", rng)
    pts = to_cpu(rng.integers(0, 2**32, size=(512, 4, 4), dtype=np.uint32))
    cs = to_cpu(rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32))
    proofs = {f: vdpf_cuda.fold(th, pts, cs, f) for f in tvdpf.FOLDS}
    for f, p in proofs.items():
        assert torch.equal(p, tvdpf.fold(th.hash64, pts, cs, f)), f
    assert len({tblk.to_numpy(p).tobytes() for p in proofs.values()}) == 3
    assert torch.equal(proofs["tree"][2:4], cs[2:4])
    with pytest.raises(ValueError):
        vdpf_cuda.fold(th, pts, cs, "flat")
