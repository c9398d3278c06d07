"""The port's DCF point evaluation against fss_tpu, byte-exact (tolerance
0: integer crypto), on the CPU.

The JAX side runs ``fss_tpu.schemes.dcf.eval_points`` under ``jax.jit``,
which the JAX suite holds equal to its Pallas kernel for these ten groups
(tests/test_tree_kernels_pallas.py); the ``uint32`` case runs that kernel
in interpret mode instead. The port runs ``dcf_cuda.eval_points``,
whose wrapper takes the plain PyTorch version for CPU tensors. The ten
groups cover all five accumulator modes. Gen is held against fss_tpu in
test_torch_dcf_gen.py (a file of its own, so that the two spread over the
test workers).
"""

import jax
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu import groups as jgroups
from fss_tpu.ops import dcf_pallas
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dcf as jdcf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch import interop
from fss_tpu_torch.ops import dcf_cuda
from fss_tpu_torch.prg.chacha import ChaCha
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x600DCAFE, 0x0BADF00D)
PRG4 = ChaCha(4, NONCE)

# The ten groups of test_tree_kernels_pallas.py, as (JAX, port) pairs.
GROUPS = {
    "uint32": (32, 0),
    "uint64": (64, 0),
    "bytes": None,
    "uint127": (128, 1 << 127),             # mod128
    "uint32_mod1e9+7": (32, 10**9 + 7),     # mod64
    "uint16_mod1000": (16, 1000),           # mod64, masked
    "uint64_mod": (64, (1 << 61) - 1),      # mod64, wide
    "uint32_mod2e16": (32, 1 << 16),        # pow2 -> wrap
    "uint127_mersenne": (128, (1 << 127) - 1),  # mod128np
    "uint126_odd": (128, (1 << 126) + 12345),   # mod128np
}


def groups_pair(gname):
    spec = GROUPS[gname]
    if spec is None:
        return jgroups.Bytes(), tgroups.Bytes()
    return jgroups.Uint(*spec), tgroups.Uint(*spec)


def to_cpu(arr):
    return interop.to_torch(arr, device="cpu")


def jax_eval(jg, in_bits, s0s, cws, xs):
    """fss_tpu.schemes.dcf.eval_points of both parties, jitted."""
    return [np.asarray(y) for y in jax.jit(lambda s, c, x: [
        jdcf.eval_points(JChaCha(4, NONCE), jg, in_bits, None, p, s[:, p], c,
                         x) for p in (0, 1)])(jblk.block(s0s), cws, xs)]


def _keys(rng, tg, in_bits, B, pred="lt"):
    """A batch of keys from the port's Gen, as uint32 numpy arrays."""
    s0s = rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint32)
    alphas = [int(a) for a in rng.integers(0, 2**min(in_bits, 63), size=B)]
    betas = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint32)
    cws = dcf_cuda.gen_batch(PRG4, tg, in_bits, pred, to_cpu(s0s),
                             tblk.pack_inputs(alphas, in_bits, "cpu"),
                             to_cpu(betas))
    return s0s, alphas, betas, tblk.to_numpy(cws)


@pytest.mark.parametrize("gname", list(GROUPS))
def test_eval_matches_jax_kernel(gname, rng):
    in_bits, B = 8, 200
    jg, tg = groups_pair(gname)
    s0s, alphas, betas, cws = _keys(rng, tg, in_bits, B)
    xs = rng.integers(0, 2**in_bits, size=B, dtype=np.uint32)
    if gname == "uint32":
        wants = [np.asarray(dcf_pallas.eval_points(
            NONCE, jg, in_bits, p, s0s[:, p], cws, xs, block_rows=8,
            interpret=True)) for p in (0, 1)]
    else:
        wants = jax_eval(jg, in_bits, s0s, cws, xs)
    shares = []
    for party, want in enumerate(wants):
        got = dcf_cuda.eval_points(PRG4, tg, in_bits, party,
                                   to_cpu(s0s[:, party]), to_cpu(cws),
                                   to_cpu(xs))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"
        shares.append(tg.from_block(got))
    # y0 + y1 = beta where x < alpha, else 0.
    rec = tg.add(*shares)
    beta = tg.from_block(tblk.clear_lsb(to_cpu(betas)))
    below = torch.from_numpy(xs.astype(np.int64) < np.array(alphas))
    assert torch.equal(rec, torch.where(below[:, None], beta,
                                        torch.zeros_like(beta)))


def test_eval_wide_domain_matches_jax_kernel(rng):
    """in_bits 48: x as 4 lanes, the bit of level i read from lane
    pos >> 5."""
    in_bits, B = 48, 64
    jg, tg = groups_pair("uint64")
    s0s, alphas, _, cws = _keys(rng, tg, in_bits, B, pred="gt")
    xs = [a + int(d) for a, d in zip(alphas, rng.integers(-2, 3, size=B))]
    xs = [x % (1 << in_bits) for x in xs]
    x_lanes = tblk.to_numpy(tblk.pack_inputs(xs, in_bits, "cpu"))
    for party, want in enumerate(jax_eval(jg, in_bits, s0s, cws, x_lanes)):
        got = dcf_cuda.eval_points(PRG4, tg, in_bits, party,
                                   to_cpu(s0s[:, party]), to_cpu(cws),
                                   to_cpu(x_lanes))
        assert np.array_equal(tblk.to_numpy(got), want), f"party {party}"


def test_broadcast_key_matches_wire_rows(rng):
    """One key [in_bits+1, 8] and one seed [4] broadcast over the batch
    give the rows of the same key repeated."""
    in_bits, B = 12, 50
    tg = tgroups.Uint(128, (1 << 127) - 1)
    s0s, _, _, cws = _keys(rng, tg, in_bits, 1)
    xs = to_cpu(rng.integers(0, 2**in_bits, size=B, dtype=np.uint32))
    one = dcf_cuda.eval_points(PRG4, tg, in_bits, 1, to_cpu(s0s[0, 1]),
                               to_cpu(cws[0]), xs)
    rows = dcf_cuda.eval_points(PRG4, tg, in_bits, 1,
                                to_cpu(np.repeat(s0s[:, 1], B, axis=0)),
                                to_cpu(np.repeat(cws, B, axis=0)), xs)
    assert torch.equal(one, rows)


def _raw(values, words):
    return to_cpu(np.array([[(v >> (32 * i)) & 0xFFFFFFFF
                             for i in range(words)] for v in values],
                           dtype=np.uint32))


@pytest.mark.parametrize("bits,mod,top", [
    (128, (1 << 127) - 1, 135),        # mod128np: 160-bit sums
    (128, (1 << 126) + 12345, 135),    # mod128np
    (128, 1 << 127, 128),              # mod128: wrapped decoded sums
    (64, (1 << 61) - 1, 72),           # mod64: exact sums
    (16, 1000, 24),                    # mod64, narrow
])
def test_acc_to_value_edges(bits, mod, top, rng):
    """The finalize's reduction of raw sums, at the edges of their range
    (the high word of a 160-bit sum set, multiples of m, all ones)."""
    tg = tgroups.Uint(bits, mod)
    mode = dcf_cuda.group_mode(tg)
    words = dcf_cuda.acc_words(mode)
    top_val = (1 << top) - 1
    values = [0, 1, mod - 1, mod, mod + 1, 3 * mod, top_val,
              top_val - mod, 1 << 128 if top > 128 else top_val >> 1,
              *(int(v) % (1 << top) for v in rng.integers(0, 2**63,
                                                          size=8))]
    values += [(v * 0x9E3779B97F4A7C15 << 40) % (1 << top) for v in values]
    got = dcf_cuda.acc_to_value(tg, _raw(values, words))
    got_ints = [tgroups.to_int(tg, row) for row in got]
    assert got_ints == [v % mod for v in values]
    want = np.asarray(dcf_pallas._acc_to_value(jgroups.Uint(bits, mod),
                                               tblk.to_numpy(_raw(values,
                                                                  words))))
    assert np.array_equal(tblk.to_numpy(got), want)


def test_modes_and_masks():
    assert [dcf_cuda.group_mode(groups_pair(g)[1]) for g in GROUPS] == [
        "wrap", "wrap", "xor", "mod128", "mod64", "mod64", "mod64", "wrap",
        "mod128np", "mod128np"]
    for g in GROUPS:
        jg, tg = groups_pair(g)
        assert dcf_cuda.value_mask(tg) == tuple(
            int(m) for m in dcf_pallas._value_mask(jg))
    assert dcf_cuda.gen_params(tgroups.Uint(32, 1 << 16)) == (
        (0xFFFF, 0, 0, 0), (0, 0, 0, 0))
    assert dcf_cuda.gen_params(tgroups.Uint(64, 1000)) == (
        (0xFFFFFFFF, 0xFFFFFFFF, 0, 0), (1000, 0, 0, 0))
    with pytest.raises(ValueError):
        dcf_cuda.eval_packed(torch.zeros(4, dtype=torch.int32),
                             torch.zeros((9, 8), dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32), 8, 0, PRG4,
                             group_mode="add")
    with pytest.raises(ValueError):  # in_bits > 32 needs x as lanes
        dcf_cuda.eval_packed(torch.zeros(4, dtype=torch.int32),
                             torch.zeros((41, 8), dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32), 40, 0, PRG4)


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


# Arguments of eval_shares that its checks refuse, as eval_packed's do:
# (s0, cws, xs, in_bits, party, prg), the case's one fault named.
_BAD_SHARES_ARGS = {
    "cws_rows": (_zeros(3, 4), _zeros(3, 8, 8), _zeros(3), 8, 0, PRG4),
    "cws_batch": (_zeros(3, 4), _zeros(2, 9, 8), _zeros(3), 8, 0, PRG4),
    "cws_words": (_zeros(4), _zeros(9, 4), _zeros(3), 8, 0, PRG4),
    "s0_batch": (_zeros(2, 4), _zeros(9, 8), _zeros(3), 8, 0, PRG4),
    "s0_words": (_zeros(3, 3), _zeros(9, 8), _zeros(3), 8, 0, PRG4),
    "xs_words_wide": (_zeros(4), _zeros(41, 8), _zeros(3), 40, 0, PRG4),
    "xs_lanes": (_zeros(4), _zeros(9, 8), _zeros(3, 2), 8, 0, PRG4),
    "party": (_zeros(4), _zeros(9, 8), _zeros(3), 8, 2, PRG4),
    "prg_mul": (_zeros(4), _zeros(9, 8), _zeros(3), 8, 0,
                ChaCha(2, NONCE)),
    "in_bits": (_zeros(4), _zeros(1, 8), _zeros(3), 0, 0, PRG4),
}


@pytest.mark.parametrize("case", list(_BAD_SHARES_ARGS))
def test_eval_shares_checks_its_arguments(case):
    s0, cws, xs, in_bits, party, prg = _BAD_SHARES_ARGS[case]
    with pytest.raises(ValueError):
        dcf_cuda.eval_shares(s0, cws, xs, in_bits, party, prg,
                             tgroups.Uint(32))


@pytest.mark.parametrize("gname", ["uint32", "bytes", "uint64_mod",
                                   "uint127", "uint127_mersenne"])
def test_eval_shares_plain_is_eval_points(gname, rng):
    """On the CPU the one-launch wrapper takes its plain version: the
    walk, then the finalize, as ``eval_points`` there."""
    in_bits, B = 10, 40
    tg = groups_pair(gname)[1]
    s0s, _, _, cws = _keys(rng, tg, in_bits, B)
    xs = to_cpu(rng.integers(0, 2**in_bits, size=B, dtype=np.uint32))
    for party in (0, 1):
        s0 = to_cpu(s0s[:, party])
        assert torch.equal(
            dcf_cuda.eval_shares(s0, to_cpu(cws), xs, in_bits, party, PRG4,
                                 tg),
            dcf_cuda.eval_points(PRG4, tg, in_bits, party, s0, to_cpu(cws),
                                 xs)), party
