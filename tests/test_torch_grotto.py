"""The port's Grotto DCF against fss_tpu and the reference's golden vectors,
byte-exact (tolerance 0: integer crypto), on the CPU.

The JAX side is ``fss_tpu.schemes.grotto_dcf``, both parties in one
program (``torch_jax.both_parties``); the port runs its plain scheme, the
EvalAll kernel's wrapper taking its plain version for CPU tensors. The
kernels themselves are held against those plain versions on the card in
test_torch_gpu_grotto_vdmpf.py.
"""

import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fss_tpu import block as jblk
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import grotto_dcf as jgrotto
from fss_tpu_torch import block as tblk
from fss_tpu_torch import interop
from fss_tpu_torch.api import GrottoDcf
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import grotto_dcf as tgrotto
from test_torch_api import golden_prg
from torch_jax import both_parties
from torch_threads import one_torch_thread  # noqa: F401

NONCE = (0x0DDBA11, 0xCAFEF00D)
VEC = pathlib.Path(__file__).resolve().parent / "golden" / "vectors"
_CASES = json.loads((VEC / "grotto.json").read_text())["cases"]


def _u32(h):
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def _np(t):
    return tblk.to_numpy(t)


def test_golden_case_count():
    assert len(_CASES) == 5


@pytest.mark.parametrize(
    "case", _CASES,
    ids=lambda c: f"{c['prg']}-{c['in_bits']}-alpha{c['alpha']}")
def test_golden(case):
    """Gen bytes, both parties' ys at every x through the ParityTree and
    the PrefixTable, and both EvalAll heads and digests."""
    n = case["in_bits"]
    d = GrottoDcf(n, golden_prg(case, 2), device="cpu")
    s0s = np.stack([_u32(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0))
    assert _np(cws).tobytes() == np.stack(
        [_u32(r) for r in case["cws"]]).tobytes(), "gen cws bytes"
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        want = [int(y) for y in case[f"ys{party}"]]
        tree = d.preprocess(party, s0s[party], cws)
        table = d.preprocess_prefix(party, s0s[party], cws)
        assert d.eval(tree, xs).tolist() == want, f"party{party} tree"
        assert d.eval(table, xs).tolist() == want, f"party{party} table"
        assert int(d.eval(tree, xs[0])) == want[0]
        raw = _np(d.eval_all(party, s0s[party], cws)).astype(
            np.uint8).tobytes()
        assert raw[:32] == bytes.fromhex(case[f"eval_all_head{party}"])
        assert (hashlib.sha256(raw).hexdigest()
                == case[f"eval_all_digest{party}"])


@pytest.mark.parametrize("in_bits", [4, 8])
def test_matches_jax(in_bits, rng):
    """EvalAll, the parity tree and its walk at every x (x = 2^n - 1, the
    whole domain, included), the prefix table's words and its queries,
    both parties, against the JAX scheme in one program; the port's shares
    reconstruct to 1[alpha <= x]. At 4 bits the prefix table pads to one
    32-bit word."""
    n = 1 << in_bits
    alpha = int(rng.integers(0, n))
    jprg, tprg = JChaCha(2, NONCE), ChaCha(2, NONCE)
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    d = GrottoDcf(in_bits, tprg, device="cpu")
    cws = d.gen(s0s, alpha)
    xs = np.arange(n, dtype=np.uint32)

    def jax_side(party, s0, c):
        bits = jgrotto.eval_all(jprg, in_bits, party, s0, c)
        tree = jgrotto.preprocess(jprg, in_bits, party, s0, c)
        table = jgrotto.build_prefix_table(bits, party)
        return jnp.concatenate(
            [bits, *tree.levels,
             jgrotto.eval_points(tree, jblk.pack_inputs(xs, in_bits)),
             table.words, jgrotto.eval_prefix(table, xs)])

    want = both_parties(jax_side, s0s, _np(cws))
    tx = torch.from_numpy(xs.view(np.int32).copy())
    shares = []
    for party in (0, 1):
        s0 = interop.to_torch(s0s[party], "cpu")
        bits = tgrotto.eval_all(tprg, in_bits, party, s0, cws)
        tree = tgrotto.preprocess(tprg, in_bits, party, s0, cws)
        table = tgrotto.build_prefix_table(bits, party)
        got = torch.cat([bits, *tree.levels,
                         tgrotto.eval_points(tree, tblk.pack_inputs(
                             tx, in_bits)),
                         table.words, tgrotto.eval_prefix(table, tx)])
        assert np.array_equal(_np(got), want[party]), f"party{party}"
        # The JAX package's tree and table, crossed, answer the same.
        jtree = jgrotto.ParityTree(
            tuple(np.asarray(level) for level in interop.parity_tree_to_jax(
                tree)[0]), party)
        assert torch.equal(tgrotto.eval_points(
            interop.parity_tree_from_jax(jtree, "cpu"),
            tblk.pack_inputs(tx, in_bits)), bits)
        jtable = jgrotto.PrefixTable(*interop.prefix_table_to_jax(table))
        assert torch.equal(tgrotto.eval_prefix(
            interop.prefix_table_from_jax(jtable, "cpu"), tx), bits)
        shares.append(bits)
    assert np.array_equal(_np(shares[0] ^ shares[1]),
                          (xs >= alpha).astype(np.uint32))


def test_config_round_trip():
    cfg = interop.grotto_config(12, JChaCha(2, NONCE, 12))
    json.dumps(cfg)  # plain values only
    d = interop.grotto_from_config(cfg, device="cpu")
    assert d.in_bits == 12 and d.device.type == "cpu"
    assert d.prg == ChaCha(2, NONCE, 12) and d.group.name == "bytes"


def test_alpha_edges(rng):
    """alpha = 0, 1 and 2^n - 1, queried at 0, alpha - 1, alpha and 2^n - 1
    through the ParityTree walk: the shares reconstruct to 1[alpha <= x],
    and at x = 2^n - 1 (the whole domain) each share is its root's
    parity."""
    in_bits = 6
    d = GrottoDcf(in_bits, ChaCha(2, NONCE), device="cpu")
    for alpha in (0, 1, (1 << in_bits) - 1):
        s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
        cws = d.gen(s0s, alpha)
        xs = [0, max(alpha - 1, 0), alpha, (1 << in_bits) - 1]
        trees = [d.preprocess(p, s0s[p], cws) for p in (0, 1)]
        rec = d.eval(trees[0], xs) ^ d.eval(trees[1], xs)
        assert rec.tolist() == [int(alpha <= x) for x in xs]
        for tree in trees:
            assert int(d.eval(tree, (1 << in_bits) - 1)) == int(
                tree.levels[0][0])
