"""The port's keyed BLAKE3 and SHA-256 against fss_tpu.hash, the
reference's primitive vectors and hashlib, and the plain versions of the
hash kernels (B-10, B-11, B-12) against the JAX package's Pallas kernels
in interpret mode, once each at the shape the JAX suite runs them
(tests/test_tree_kernels_pallas.py). Tolerance 0 throughout (integer
crypto), on the CPU, where each wrapper takes its plain PyTorch version.
"""

import hashlib
import importlib.util
import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from fss_tpu.hash import blake3 as jb3
from fss_tpu.hash import sha256 as jsh
from fss_tpu.ops import blake3_pallas, sha256_pallas
from fss_tpu.schemes import vdpf as jvdpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import interop
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.hash import blake3 as tb3
from fss_tpu_torch.hash import sha256 as tsh
from fss_tpu_torch.ops import blake3_cuda, sha256_cuda
from torch_threads import one_torch_thread  # noqa: F401

VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"
PAIRS = {
    "blake3": (lambda k: jb3.Blake3(tuple(k)), Blake3, 8),
    "sha256": (lambda k: jsh.Sha256(tuple(k)), Sha256, 4),
}


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def _np(t):
    return tblk.to_numpy(t)


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_hashes_match_jax(name, rng):
    """hash64 and xor_hash of random rows, lane 3's LSB of a set and
    clear, and batch shapes with more than one leading dim."""
    jmake, tmake, nkey = PAIRS[name]
    key = rng.integers(0, 2**32, size=nkey, dtype=np.uint32)
    jh, th = jmake(key), tmake(key)
    assert th == tmake(jax.numpy.asarray(key)) == tmake(to_cpu(key))
    msg = rng.integers(0, 2**32, size=(3, 5, 4, 4), dtype=np.uint32)
    a = rng.integers(0, 2**32, size=(15, 4), dtype=np.uint32)
    a[::2, 3] |= 1
    b = rng.integers(0, 2**32, size=(15, 4), dtype=np.uint32)
    want = jax.jit(lambda m, x, y: (jh.hash64(m), jh.xor_hash(x, y)))(
        msg, a, b)
    got = th.hash64(to_cpu(msg)), th.xor_hash(to_cpu(a), to_cpu(b))
    assert got[0].shape == (3, 5, 2, 4) and got[1].shape == (15, 4, 4)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_blake3_compress_matches_oracles(rng):
    """compress_words against the Python oracle and fss_tpu's."""
    h = rng.integers(0, 2**32, size=8, dtype=np.uint32)
    m = rng.integers(0, 2**32, size=(16, 6), dtype=np.uint32)
    for block_len in (32, 64):
        got = tb3.compress_words([int(w) for w in h],
                                 [tblk.u64(to_cpu(r)) for r in m], block_len)
        for j in range(m.shape[1]):
            want = tb3.compress_reference(h, m[:, j], block_len)
            assert np.array_equal(want, jb3.compress_reference(
                h, m[:, j], block_len))
            assert [int(w[j]) for w in got] == [int(w) for w in want]


def test_sha256_matches_hashlib(rng):
    """hash64 = SHA-256(key || msg); xor_hash = SHA-256(key || a' || b)
    with a' = a with lane 3's LSB 0, then 1."""
    key = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    msg = rng.integers(0, 2**32, size=(4, 4, 4), dtype=np.uint32)
    a = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    h = Sha256(key)
    got = _np(h.hash64(to_cpu(msg)))
    pis = _np(h.xor_hash(to_cpu(a), to_cpu(b)))
    for i in range(4):
        assert got[i].tobytes() == hashlib.sha256(
            key.tobytes() + msg[i].tobytes()).digest()
        for lsb in (0, 1):
            ai = a[i].copy()
            ai[3] = (ai[3] & 0xFFFFFFFE) | lsb
            assert pis[i, 2 * lsb:2 * lsb + 2].tobytes() == hashlib.sha256(
                key.tobytes() + ai.tobytes() + b[i].tobytes()).digest()
    assert tsh.bswap32(0x11223344) == 0x44332211


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_primitives_golden(name):
    """The reference's own hash64 and xor_hash bytes."""
    entries = json.loads((VEC / "primitives.json").read_text())[name]
    assert entries
    for e in entries:
        h = PAIRS[name][1](_u32(e["iv" if name == "blake3" else "key"]))
        msg = to_cpu(_u32(e["msg"]).reshape(4, 4))
        assert _np(h.hash64(msg)).tobytes() == bytes.fromhex(e["hash"])
        out = h.xor_hash(to_cpu(_u32(e["x"])), to_cpu(_u32(e["s"])))
        assert _np(out).tobytes() == bytes.fromhex(e["xor_hash"])


@pytest.mark.parametrize(
    "name,points", [(n, "random") for n in sorted(PAIRS)]
    + [("sha256", "below_2_32"), ("sha256", "mixed")],
    ids=sorted(PAIRS) + ["sha256-below_2_32", "sha256-mixed"])
def test_xor_hash_matches_pallas_kernel(name, points, rng):
    """B-10 (blake3_pallas) and B-12 (sha256_pallas) XorHash, 300 rows of
    random points; B-12 also on points below 2^32 (lanes 1-3 zero but for
    the domain bit, set and clear), alone or every third row."""
    nkey = PAIRS[name][2]
    key = tuple(int(v) for v in rng.integers(0, 2**32, size=nkey))
    a = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(300, 4), dtype=np.uint32)
    if points != "random":
        small = a[::3] if points == "mixed" else a
        small[:, 1:3] = 0
        small[:, 3] &= 1
    kern = {"blake3": blake3_pallas, "sha256": sha256_pallas}[name]
    want = kern.xor_hash_batch(a, b, key, block_rows=8, interpret=True)
    wrapper = {"blake3": blake3_cuda, "sha256": sha256_cuda}[name]
    got = wrapper.xor_hash(key, to_cpu(a), to_cpu(b))
    assert np.array_equal(_np(got), np.asarray(want))


def test_hash64_matches_pallas_kernel(rng):
    """B-11 (blake3_pallas.hash64_batch), 300 rows; and the SHA-256 H'
    entry point against Sha256.hash64 of fss_tpu (XLA, no kernel)."""
    iv = tuple(int(v) for v in rng.integers(0, 2**32, size=8))
    msg = rng.integers(0, 2**32, size=(300, 4, 4), dtype=np.uint32)
    want = blake3_pallas.hash64_batch(msg, iv, block_rows=8, interpret=True)
    got = blake3_cuda.hash64(iv, to_cpu(msg))
    assert np.array_equal(_np(got), np.asarray(want))
    key = iv[:4]
    assert np.array_equal(
        _np(sha256_cuda.hash64(key, to_cpu(msg[:40]))),
        np.asarray(jax.jit(jsh.Sha256(key).hash64)(msg[:40])))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_chain_matches_prove(name, rng):
    """The one-thread chain's plain version against fss_tpu's flat fold
    (schemes/vdpf.py:prove), 24 points, and no points (the fold is cs)."""
    jmake, tmake, nkey = PAIRS[name]
    key = rng.integers(0, 2**32, size=nkey, dtype=np.uint32)
    pts = rng.integers(0, 2**32, size=(24, 4, 4), dtype=np.uint32)
    cs = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    want = jax.jit(lambda p, c: jvdpf.prove(jmake(key).hash64, p, c))(
        pts, cs)
    wrapper = {"blake3": blake3_cuda, "sha256": sha256_cuda}[name]
    assert np.array_equal(_np(wrapper.chain(key, to_cpu(pts), to_cpu(cs))),
                          np.asarray(want))
    assert np.array_equal(
        _np(wrapper.chain(key, to_cpu(pts[:0]), to_cpu(cs))), cs)


def test_wrappers_validate_inputs():
    rows = torch.zeros((4, 4), dtype=torch.int32)
    iv, key = tuple(range(8)), tuple(range(4))
    with pytest.raises(ValueError):  # a and b are [N, 4] rows
        blake3_cuda.xor_hash(iv, rows, torch.zeros((5, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        sha256_cuda.xor_hash(key, rows.long(), rows)
    with pytest.raises(ValueError):  # H' takes [N, 4, 4]
        blake3_cuda.hash64(iv, rows)
    with pytest.raises(ValueError):
        sha256_cuda.chain(key, torch.zeros((3, 4, 4), dtype=torch.int32),
                          rows[:2])
    with pytest.raises(ValueError):
        Blake3(range(7))
    with pytest.raises(ValueError):
        Sha256(range(5))
    with pytest.raises(ValueError):
        blake3_cuda.hash64(range(4), torch.zeros((1, 4, 4),
                                                 dtype=torch.int32))


def test_hash_variants_patch_each_choice(tmp_path):
    """scripts/torch_hash_variants.py finds each design choice it varies
    exactly once at the top of the source it patches, csrc/blake3.cu or
    csrc/sha256.cu (each ring's size as its wrapper's CHAIN_RING says)."""
    repo = VEC.parents[2]
    spec = importlib.util.spec_from_file_location(
        "torch_hash_variants", repo / "scripts" / "torch_hash_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    csrc = repo / "fss_tpu_torch" / "csrc"
    assert (f"constexpr int kRing = {sha256_cuda.CHAIN_RING};"
            in (csrc / "sha256.cu").read_text())
    assert (f"constexpr int kRing = {blake3_cuda.CHAIN_RING};"
            in (csrc / "blake3.cu").read_text())
    assert {variants.source_of(name) for name in variants.VARIANTS} == {
        "blake3", "sha256"}
    for name, choices in variants.VARIANTS.items():
        text = (variants.patch(csrc, name, choices, tmp_path)
                / f"{variants.source_of(name)}.cu").read_text()
        for key, value in choices.items():
            assert re.search(rf"^(using|constexpr \w+) {key} = "
                             rf"{re.escape(value)};", text, re.M), (name, key)
