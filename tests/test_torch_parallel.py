"""The port's sharded paths (``fss_tpu_torch.parallel``) against fss_tpu,
byte-exact (tolerance 0: integer crypto), on the CPU.

One gloo world of 4 ranks, spawned once for the module, runs every
function of ``parallel.mesh`` (``torch_ranks.run_all``) with the domain
and data axes sharded 2 ways (a 2 x 2 mesh) and 4 ways, and sends back
what each rank holds. The DPF, DCF, Half-Tree and Grotto shards are held
against the JAX package's single-device EvalAll (both parties in one
program, ``torch_jax.both_parties``), as the JAX package's own sharded
functions are; the VDPF and VDMPF proofs, which depend on the shard count
by design, against ``fss_tpu.parallel.mesh``'s sharded functions on a JAX
CPU mesh of the same shard count; the PIR share against its
``pir_lookup_sharded``. The per-rank slicing of the EvalAll plan
(``eval_all_cuda.shard_plan``) is also checked in this process, one shard
at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fss_tpu import groups as jgroups
from fss_tpu.api import Vdmpf as JVdmpf
from fss_tpu.api import Vdpf as JVdpf
from fss_tpu.hash import blake3 as jb3
from fss_tpu.parallel import mesh as jmesh
from fss_tpu.prg.chacha import ChaCha as JChaCha
from fss_tpu.schemes import dcf as jdcf
from fss_tpu.schemes import dpf as jdpf
from fss_tpu.schemes import grotto_dcf as jgrotto
from fss_tpu.schemes import half_tree_dpf as jht
from fss_tpu.schemes import vdmpf as jvdmpf
from fss_tpu_torch import block as tblk
from fss_tpu_torch import groups as tgroups
from fss_tpu_torch.ops import eval_all_cuda
from fss_tpu_torch.parallel import spawn
from torch_jax import FAST_COMPILE, both_parties
from torch_threads import one_torch_thread  # noqa: F401
import torch_ranks as R

N = 1 << R.BITS


@pytest.fixture(scope="module")
def keys():
    return R.make_keys()


@pytest.fixture(scope="module")
def world(keys):
    """(keys, the 4 ranks' outputs in rank order)."""
    return keys, spawn.run(R.run_all, 4, (keys, "cpu"), backend="gloo",
                           wait_s=300)


def _shard(results, rank, shards):
    """(rank's shard index, rows a shard) on the domain axis of
    ``shards`` shards: the 2 x 2 mesh's column, or the rank."""
    idx = results[rank]["coord"][1] if shards == 2 else rank
    return idx, N // shards


def _fast(fn, *args):
    """``fn(*args)`` as one program compiled with FAST_COMPILE (the JAX
    package's own jitted functions inline into it)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _jax_dpf(s0s, cws):
    """The JAX package's single-device DPF EvalAll of both parties, the
    program compiled once for every key of this shape."""
    global _DPF
    if _DPF is None:
        _DPF = jax.jit(lambda s, c: [jdpf.eval_all(
            JChaCha(2, R.NONCE), jgroups.Uint(64), R.BITS, p, s[p], c)
            for p in (0, 1)]).lower(s0s, cws).compile(FAST_COMPILE)
    return [np.asarray(y) for y in _DPF(s0s, cws)]


_DPF = None


def _jax_single(scheme, K):
    """The JAX package's single-device EvalAll of both parties."""
    if scheme == "dpf":
        return _jax_dpf(K["s0s"], K["dpf"])
    if scheme == "dcf":
        return both_parties(lambda p, s, c: jdcf.eval_all(
            JChaCha(4, R.NONCE), jgroups.Uint(32), R.BITS, p, s, c),
            K["s0s"], K["dcf"])
    if scheme == "grotto":
        return both_parties(lambda p, s, c: jgrotto.eval_all(
            JChaCha(2, R.NONCE), R.BITS, p, s, c), K["s0s"], K["grotto"])
    cws, ocw = (jnp.asarray(a) for a in K["ht"])
    hk = jnp.asarray(np.asarray(R.HASH_KEY, np.uint32))
    return both_parties(lambda p, s, c: jht.eval_all(
        JChaCha(1, R.NONCE), jgroups.Uint(64), R.BITS, p, hk, s, c, ocw),
        K["s0s"], cws)


@pytest.mark.parametrize("scheme", ["dpf", "dcf", "ht", "grotto"])
def test_domain_sharded_eval_all_matches_jax(scheme, world):
    """Each rank's shard, of 2 and of 4, equals its slice of the JAX
    package's single-device EvalAll, for both parties."""
    K, results = world
    want = _jax_single(scheme, K)
    for shards in R.SHARDS:
        for rank, res in enumerate(results):
            idx, rows = _shard(results, rank, shards)
            for p in (0, 1):
                got = res["domain", shards][scheme, p]
                assert got.shape[0] == rows
                assert np.array_equal(got.reshape(rows, -1),
                                      want[p][idx * rows:(idx + 1) * rows]
                                      .reshape(rows, -1)), (shards, rank, p)


@pytest.mark.parametrize("shards", R.SHARDS)
def test_vdpf_two_level_proof_matches_jax(shards, world):
    """The VDPF's shards and two-level proof (each shard's chain from cs,
    then the chain of the shard proofs from cs) equal
    ``fss_tpu.parallel.mesh.vdpf_eval_all_sharded`` on a JAX mesh of the
    same shard count; both parties' proofs are equal on every rank and
    the shares reconstruct to the point function."""
    K, results = world
    jd = JVdpf(R.BITS, group=jgroups.Bytes(), prg=JChaCha(2, R.NONCE),
               hashes=jb3.Blake3(R.IV))
    mesh = jmesh.make_mesh(shards, axis_names=("domain",))
    ys, pi = _fast(lambda s0, cws, cs, ocw: jmesh.vdpf_eval_all_sharded(
        jd.prg, jd.xor_hash, jd.hash64, jd.group, R.BITS, 0, s0, cws, cs,
        ocw, mesh, axis="domain"), K["vdpf_s0s"][0], *K["vdpf"])
    ys, pi = np.asarray(ys), np.asarray(pi)
    parts = {}
    for rank, res in enumerate(results):
        idx, rows = _shard(results, rank, shards)
        for p in (0, 1):
            y, got_pi = res["domain", shards]["vdpf", p]
            assert np.array_equal(got_pi, pi), (rank, p)
            parts[idx, p] = y
        assert np.array_equal(parts[idx, 0], ys[idx * rows:(idx + 1) * rows])
    rec = np.concatenate([parts[i, 0] ^ parts[i, 1] for i in range(shards)])
    assert np.nonzero(rec.any(-1))[0].tolist() == [R.VDPF_ALPHA]


def test_pir_share_matches_jax(world):
    """Every rank's answer share, with 2 and 4 shards, equals the JAX
    package's ``pir_lookup_sharded`` (4 shards), and the two parties'
    shares add to the row."""
    K, results = world
    mesh = jmesh.make_mesh(4, axis_names=("domain",))
    want = np.asarray(_fast(lambda s0, cws, db: jmesh.pir_lookup_sharded(
        JChaCha(2, R.NONCE), R.BITS, 0, s0, cws, db, mesh, axis="domain"),
        K["s0s"][0], K["pir"], K["db"].view(np.int32)))
    for shards in R.SHARDS:
        for res in results:
            a0, a1 = (res["domain", shards]["pir", p] for p in (0, 1))
            assert np.array_equal(a0, want.view(np.uint32))
            assert np.array_equal(a0 + a1, K["db"][R.PIR_INDEX])


@pytest.mark.parametrize("shards", R.SHARDS)
def test_vdmpf_shard_merged_proof(shards, world):
    """The data-sharded VDMPF (13 points: 2 shards of 7 and 6, 4 of 4, 4,
    4 and 1): with 4 shards, the shares and the proof merged from the
    shards' tree folds equal ``fss_tpu.parallel.mesh.
    vdmpf_batch_eval_sharded`` on a JAX mesh of 4; with either count,
    both parties' proofs are equal on every rank and the shares
    reconstruct to the payloads."""
    K, results = world
    eta = len(K["vdmpf_xs"])
    rows = -(-eta // shards)
    parts, pis = {}, set()
    for rank, res in enumerate(results):
        idx = res["coord"][0] if shards == 2 else rank
        for p in (0, 1):
            y, got_pi, shape = res["data", shards]["vdmpf", p]
            assert shape == (eta, 4) and y.shape[0] == min(
                rows, eta - idx * rows)
            pis.add(got_pi.tobytes())
            parts[idx, p] = y
    assert len(pis) == 1
    if shards == 4:
        jd = JVdmpf(R.VDMPF_BITS, group=jgroups.Uint(64),
                    prg=JChaCha(2, R.NONCE), hashes=jb3.Blake3(R.IV))
        mesh = jmesh.make_mesh(shards, axis_names=("data",))
        ys, pi = _fast(lambda *a: jmesh.vdmpf_batch_eval_sharded(
            jd.prg, jd.xor_hash, jd.hash64, jd.group, R.VDMPF_BITS,
            jd.bucket_bits, 0, jvdmpf.VdmpfKey(*K["vdmpf"][0][:3], *a),
            K["vdmpf_xs"], mesh), *K["vdmpf"][0][3:])
        assert pis == {np.asarray(pi).tobytes()}
        assert np.array_equal(np.concatenate(
            [parts[i, 0] for i in range(shards)]), np.asarray(ys))
    g = tgroups.Uint(64)
    rec = tblk.to_numpy(g.add(*(
        g.from_block(tblk.words(np.concatenate(
            [parts[i, p] for i in range(shards)]))) for p in (0, 1))))
    beta_of = dict(zip(K["vdmpf_alphas"], K["vdmpf_betas"][:, 0]))
    assert rec[:, 0].tolist() == [int(beta_of.get(int(x), 0))
                                  for x in K["vdmpf_xs"]]


@pytest.mark.parametrize("shards", R.SHARDS)
def test_data_sharded_batch_reconstructs(shards, world):
    """A DPF key batch sharded on the data axis (``shard_batch``): the
    ranks' Eval shares at each key's alpha add to its beta."""
    K, results = world
    parts = {}
    for rank, res in enumerate(results):
        idx = res["coord"][0] if shards == 2 else rank
        parts[idx] = [res["data", shards]["batch", p] for p in (0, 1)]
    y0, y1 = (np.concatenate([parts[i][p] for i in range(shards)])
              for p in (0, 1))
    assert np.array_equal((y0 + y1)[:, 0], K["batch_betas"][:, 0])


def test_data_by_domain_mesh_matches_jax(world):
    """The 2 x 2 mesh: 4 keys on "data" (2 a row), each key's domain on
    "domain" (2 shards), both parties, each rank's [2, 2^(n-1), 4] block
    against the JAX package's single-device EvalAll of each key; the
    DTensor is (Shard(0), Shard(1)) of [4, 2^n, 4]."""
    K, results = world
    want = np.stack([_jax_dpf(K["mesh_s0s"][i], K["mesh_cws"][i])
                     for i in range(R.MESH_KEYS)], 1)  # [party, key, ...]
    half = N // 2
    for res in results:
        i, j = res["coord"]
        assert res["mesh2d_layout"] == (["S(0)", "S(1)"],
                                        (R.MESH_KEYS, N, 4))
        for p in (0, 1):
            assert np.array_equal(res["mesh2d", p],
                                  want[p, 2 * i:2 * i + 2,
                                       j * half:(j + 1) * half])


def test_one_leaf_a_shard(world):
    """4 shards of a 2-bit DPF domain (k = in_bits): each rank's one leaf
    is its row of the unsharded EvalAll, both parties."""
    K, results = world
    d = R.schemes("cpu")["dpf"]
    for p in (0, 1):
        full = tblk.to_numpy(eval_all_cuda.eval_all(
            d.prg, tgroups.Uint(64), R.TINY_BITS, p,
            tblk.words(K["s0s"][p]), tblk.words(K["tiny"])))
        for rank, res in enumerate(results):
            assert np.array_equal(res["tiny"][p], full[rank:rank + 1])


def test_mesh_layout_replicate_and_psum(world):
    """make_multihost_mesh puts the hosts (2 ranks each) on "data";
    replicate gives every rank rank 0's array; reconstruct_uint_psum adds
    the 4 ranks' values."""
    _, results = world
    assert [res["coord"] for res in results] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    for res in results:
        assert res["replicated"].tolist() == [1000] * 3
        assert res["psum"].tolist() == [[10, 0, 0, 0]]


# ---------------------------------------------------------------------------
# The per-rank slicing, one shard at a time
# ---------------------------------------------------------------------------

def _runs(S, K):
    """scheme -> fn(most, shard) over one key of party 0 (the DPF's seeds
    epilogue as "seeds")."""
    s0 = tblk.words(K["s0s"][0])
    cws = {k: tblk.words(K[k]) for k in ("dpf", "dcf")}
    ht = [tblk.words(a) for a in K["ht"]]
    d, c, h = S["dpf"], S["dcf"], S["ht"]
    return {
        "dpf": lambda m, sh: eval_all_cuda.eval_all(
            d.prg, d.group, R.BITS, 0, s0, cws["dpf"], m, sh),
        "seeds": lambda m, sh: torch.cat([
            x.reshape(x.shape[0], -1) for x in eval_all_cuda.expand_leaves(
                d.prg, R.BITS, 0, s0, cws["dpf"], m, sh)], 1),
        "dcf": lambda m, sh: eval_all_cuda.dcf_eval_all(
            c.prg, c.group, R.BITS, 0, s0, cws["dcf"], m, sh),
        "ht": lambda m, sh: eval_all_cuda.ht_eval_all(
            h.prg, h.group, R.BITS, 0, h.hash_key, s0, *ht, m, sh),
    }


@pytest.mark.parametrize("scheme", ["dpf", "seeds", "dcf", "ht"])
@pytest.mark.parametrize("k", [1, 2, 5, R.BITS - 1])
def test_shard_plan_slices(scheme, k, keys):
    """Shard r of 2^k (k < in_bits) of each EvalAll, under a cap on the
    subtree levels that puts the top/body boundary below and above k, is
    rows [r 2^(n-k), (r+1) 2^(n-k)) of the unsharded output."""
    run = _runs(R.schemes("cpu"), keys)[scheme]
    full = run(eval_all_cuda.SUBTREE_LEVELS, (0, 1))
    rows = N >> k
    for most in (1, 3, eval_all_cuda.SUBTREE_LEVELS):
        for r in {0, (1 << k) - 1, (1 << k) // 2}:
            got = run(most, (r, 1 << k))
            assert torch.equal(got, full[r * rows:(r + 1) * rows]), (most, r)


def test_shard_plan_caps_and_refuses():
    """The cap keeps the top launch's 2^K roots at least 2^k; a shard
    index or count out of range, or 2^in_bits shards, is refused."""
    assert eval_all_cuda.shard_plan(24, 12, (1, 2)) == (12, 1, 1)
    assert eval_all_cuda.shard_plan(8, 12, (3, 64)) == (2, 3, 6)
    for n, most, (r, count) in ((8, 12, (5, 64)), (24, 12, (0, 4096))):
        m, _, k = eval_all_cuda.shard_plan(n, most, (r, count))
        assert n - eval_all_cuda.subtree_levels(n, m) >= k
    for bad in ((0, 3), (2, 2), (-1, 2), (0, 256)):
        with pytest.raises(ValueError):
            eval_all_cuda.shard_plan(8, 12, bad)
