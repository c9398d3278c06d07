"""fss_tpu_torch.block / fss_tpu_torch.groups against fss_tpu's, byte-exact.

Inputs are made with numpy from a seed and go through both packages; the
port's int32 tensors are compared with the JAX uint32 arrays bit for bit.
"""

import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from torch_threads import one_torch_thread  # noqa: F401

EDGE = np.array([[0, 0, 0, 0],
                 [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF],
                 [0xFFFFFFFF, 0, 0xFFFFFFFF, 0],
                 [1, 0, 0, 0xFFFFFFFE]], dtype=np.uint32)

GROUPS = [
    ("bytes", {}),
    ("uint", {"bits": 8}),
    ("uint", {"bits": 16}),
    ("uint", {"bits": 32}),
    ("uint", {"bits": 64}),
    ("uint", {"bits": 64, "mod": (1 << 61) - 1}),
    ("uint", {"bits": 32, "mod": 1000003}),
    ("uint", {"bits": 8, "mod": 128}),
    ("uint", {"bits": 32, "mod": 1 << 32}),
    ("uint", {"bits": 128, "mod": 1 << 127}),
    ("uint", {"bits": 128, "mod": (1 << 127) - 1}),
]


def _ids(case):
    kind, kw = case
    return kind + "".join(f"-{k}{v}" for k, v in kw.items())


def _pair(case):
    kind, kw = case
    if kind == "bytes":
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(**kw), tgroups.Uint(**kw)


def _values(rng, n=37):
    return np.concatenate([EDGE, rng.integers(0, 2**32, size=(n, 4),
                                              dtype=np.uint32)])


def _eq(got, want):
    assert np.array_equal(tblk.to_numpy(got), np.asarray(want)), \
        (tblk.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("case", GROUPS, ids=_ids)
def test_group_ops_match_jax(case, rng):
    jg, tg = _pair(case)
    a = _values(rng)
    b = rng.permutation(_values(rng))
    ja, jb = jblk.block(a), jblk.block(b)
    ta, tb = tblk.block(a), tblk.block(b)
    _eq(tg.from_block(ta), jg.from_block(ja))
    va_j, vb_j = jg.from_block(ja), jg.from_block(jb)
    va_t, vb_t = tg.from_block(ta), tg.from_block(tb)
    _eq(tg.add(va_t, vb_t), jg.add(va_j, vb_j))
    _eq(tg.neg(va_t), jg.neg(va_j))
    _eq(tg.into_block(va_t), jg.into_block(va_j))
    _eq(tg.zero((3,)), jg.zero((3,)))
    assert tg.name == jg.name


@pytest.mark.parametrize("in_bits", [5, 32, 48, 128])
def test_pack_inputs_and_bits_match_jax(in_bits, rng):
    vals = [int(v) for v in rng.integers(0, 2**63, size=9)]
    vals = [v % (1 << in_bits) for v in vals] + [0, (1 << in_bits) - 1]
    want = np.asarray(jblk.pack_inputs(vals, in_bits))
    got = tblk.pack_inputs(vals, in_bits)
    _eq(got, want)
    _eq(tblk.input_bits_msb_first(got, in_bits),
        jblk.input_bits_msb_first(jblk.pack_inputs(vals, in_bits), in_bits))
    assert tblk.unpack_int(tblk.pack_int(vals[0])) == vals[0]
    assert np.array_equal(tblk.pack_int(vals[1]), jblk.pack_int(vals[1]))
    if in_bits <= 32:
        flat = np.asarray(vals, dtype=np.uint32)
        _eq(tblk.pack_inputs(flat, in_bits), jblk.pack_inputs(flat, in_bits))


def test_block_lsb_ops_match_jax(rng):
    a = _values(rng)
    bits = rng.integers(0, 2, size=a.shape[0], dtype=np.uint32)
    ja, ta = jblk.block(a), tblk.block(a)
    _eq(tblk.set_lsb(ta, tblk.words(bits)), jblk.set_lsb(ja, bits))
    _eq(tblk.get_lsb(ta), jblk.get_lsb(ja))
    _eq(tblk.clear_lsb(ta), jblk.clear_lsb(ja))
    d = rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
    _eq(tblk.masked_xor(tblk.words(bits), ta, tblk.block(d)),
        jblk.masked_xor(bits, ja, jblk.block(d)))
    _eq(tblk.xor(ta, tblk.block(d)), jblk.xor(ja, jblk.block(d)))
    _eq(tblk.from_words(*tblk.to_words(ta)), a)


def test_word_conversions_keep_bits():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                    dtype=np.uint32)
    t = tblk.words(vals)
    assert t.dtype.is_signed and t.element_size() == 4
    assert np.array_equal(tblk.to_numpy(t), vals)
    assert np.array_equal(tblk.u64(t).numpy(), vals.astype(np.int64))
    assert np.array_equal(tblk.to_numpy(tblk.i32(tblk.u64(t))), vals)
    assert np.array_equal(tblk.to_numpy(tblk.words(vals.tolist())), vals)
    assert np.array_equal(tblk.to_numpy(tblk.words(vals.view(np.int32))),
                          vals)
    assert tgroups.to_int(tgroups.Uint(128, 1 << 127),
                          tblk.block([1, 2, 3, 4])) == \
        jgroups.to_int(None, [1, 2, 3, 4])


# block.words on 64-bit inputs takes the low word of each value's bytes;
# every case keeps the bytes (and shape) of the masked uint32 conversion.
_WIDE = np.array([[0, -1, -(1 << 31), (1 << 63) - 1],
                  [-(1 << 63), 1 << 32, -(1 << 32) - 3, 0x1234_5678_9ABC_DEF0]],
                 dtype=np.int64)
WORDS_CASES = {
    "int64": _WIDE,
    "uint64": _WIDE.view(np.uint64),
    "int64-big-endian": _WIDE.astype(">i8"),
    "int64-slice": np.tile(_WIDE, (3, 2))[::2, 1::3],
    "int64-0d": np.array(-(1 << 40) - 9),
    "python-ints": [1 << 32, (1 << 33) + 5, 7, (1 << 62) + 1],
}


@pytest.mark.parametrize("case", list(WORDS_CASES))
def test_words_keep_low_words(case):
    vals = WORDS_CASES[case]
    arr = np.asarray(vals)
    want = np.ascontiguousarray(
        (arr.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    for device in (None, "cpu"):
        got = tblk.words(vals, device)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert tuple(got.shape) == want.shape
        assert tblk.to_numpy(got).tobytes() == want.tobytes()
