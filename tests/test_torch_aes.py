"""The port's AES-128-MMO PRG: the FIPS-197 vector through the oracle,
the JAX package's table form and the reference's own bytes
(primitives.json), and the kernels' round-key argument."""

import ctypes
import ctypes.util
import json
import pathlib

import numpy as np
import pytest

from fss_tpu import block as jblk
from fss_tpu.prg import aes as jaes
from fss_tpu_torch import _build
from fss_tpu_torch import block as tblk
from fss_tpu_torch.prg import aes as taes
from fss_tpu_torch.prg.chacha import ChaCha
from torch_threads import one_torch_thread  # noqa: F401

VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"


def test_fips197_c1():
    key = bytes(range(16))
    plain = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert taes.aes128_encrypt_reference(key, plain).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_tables_and_key_schedule_match_jax(rng):
    assert np.array_equal(taes.SBOX, jaes.SBOX)
    assert np.array_equal(taes.TE0, jaes.TE0)
    for _ in range(4):
        key = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
        assert np.array_equal(taes.key_expansion(key),
                              jaes.key_expansion(key))


@pytest.mark.parametrize("mul", [1, 2, 4])
def test_aes_mmo_matches_jax_and_oracle(mul, rng):
    keys = [bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
            for _ in range(mul)]
    seeds = rng.integers(0, 2**32, size=(3, 5, 4), dtype=np.uint32)
    outs = taes.AesMmo(mul, keys)(tblk.block(seeds))
    want = jaes.Aes128Mmo(mul, keys, backend="table")(jblk.block(seeds))
    assert len(outs) == mul
    for got, w in zip(outs, want):
        assert got.shape == (3, 5, 4)
        assert np.array_equal(tblk.to_numpy(got), np.asarray(w))
    # out_i = AES_{k_i}(seed) ^ seed, the seed's lanes as the block's bytes.
    seed = seeds[1, 2]
    for key, got in zip(keys, outs):
        enc = np.frombuffer(taes.aes128_encrypt_reference(
            key, seed.astype("<u4").tobytes()), "<u4")
        assert np.array_equal(tblk.to_numpy(got)[1, 2], enc ^ seed)


def test_reference_bytes():
    for entry in json.loads((VEC / "primitives.json").read_text())["aes_mmo"]:
        keys = [bytes.fromhex(k) for k in entry["keys"]]
        seed = np.frombuffer(bytes.fromhex(entry["seed"]), "<u4")
        outs = taes.AesMmo(4, keys)(tblk.block(seed))
        got = b"".join(tblk.to_numpy(o).tobytes() for o in outs)
        assert got == bytes.fromhex(entry["out4"])


def test_rejects_bad_parameters():
    with pytest.raises(ValueError):
        taes.AesMmo(3, [bytes(16)] * 3)
    with pytest.raises(ValueError):
        taes.AesMmo(2, [bytes(16)])
    with pytest.raises(ValueError):
        taes.AesMmo(1, [bytes(15)])


def test_kernel_prg_argument():
    """The kernels' fss::PrgArg: AES round keys key-major, [mul][44]
    big-endian words; ChaCha's nonce and rounds; it crosses ctypes as the
    entry points' ``const void*`` (read back here through libc's memcpy);
    a PRG of another mul, or no PRG, is refused before any launch."""
    keys = [bytes(range(16 * i, 16 * i + 16)) for i in range(4)]
    ptr, tag = _build.prg_arg(taes.AesMmo(4, keys), 4)
    arg = ptr.contents
    words = np.array(arg.rk, dtype=np.uint32).reshape(4, 44)
    want = np.stack([jaes.key_expansion(k).reshape(44) for k in keys])
    assert tag == "_aes" and arg.kind == 1 and np.array_equal(words, want)
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.memcpy.argtypes = [_build.P, _build.P, ctypes.c_size_t]
    libc.memcpy.restype = _build.P
    copy = (ctypes.c_uint32 * 180)()
    libc.memcpy(copy, ptr, ctypes.sizeof(arg))
    assert list(copy) == [1, 0, 0, 0, *want.reshape(-1).tolist()]
    ptr, tag = _build.prg_arg(ChaCha(1, (5, 6), 8), 1)
    arg = ptr.contents
    assert (tag, arg.kind, arg.n0, arg.n1, arg.rounds) == ("", 0, 5, 6, 8)
    with pytest.raises(ValueError):
        _build.prg_arg(taes.AesMmo(2, keys[:2]), 4)
    with pytest.raises(ValueError):
        _build.prg_arg((5, 6), 2)
