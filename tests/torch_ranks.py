"""Ranks of the port's sharded-path tests (``fss_tpu_torch.parallel``).

One world of 4 ranks runs every function of ``parallel.mesh`` on small keys
and returns what each rank holds. The keys come from :func:`make_keys`
(the port's Gen on the CPU from a numpy seed, as numpy words), made once
by the test and handed to the ranks. The domain axis is sharded 2 ways
(the "domain" axis of a 2 x 2 ("data", "domain") mesh, replicated on
"data") and 4 ways (a 1D mesh of the world); the data axis the same way.
The module imports no JAX, so the ranks start quickly and the card's tests
use it as well:

    results = spawn.run(torch_ranks.run_all, 4, (keys, "cpu"),
                        backend="gloo")
"""

import os

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dcf, Dpf, GrottoDcf, HalfTreeDpf, Vdmpf, Vdpf
from fss_tpu_torch.hash import Blake3
from fss_tpu_torch.parallel import mesh as pm
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import vdmpf as tvdmpf

BITS = 8             # the domain of the EvalAll schemes and of the PIR
TINY_BITS = 2        # a domain of one leaf a shard with 4 shards
VDMPF_BITS = 10
BATCH = 8            # data-sharded keys
MESH_KEYS = 4        # keys of the 2 x 2 data x domain EvalAll
PIR_WORDS = 3
NONCE = (0x9E3779B9, 0x7F4A7C15)
IV = tuple(range(0x31, 0x39))
HASH_KEY = (0x0BADF00D, 0x1, 0x2, 0xFEEDFACE)
ALPHA, GROTTO_ALPHA, PIR_INDEX, VDPF_ALPHA = 77, 100, 201, 123
SHARDS = (2, 4)      # shard counts of each axis


def schemes(dev) -> dict:
    """The port's scheme objects of the tests, on ``dev``."""
    return {
        "dpf": Dpf(BITS, groups.Uint(64), ChaCha(2, NONCE), device=dev),
        "dcf": Dcf(BITS, groups.Uint(32), ChaCha(4, NONCE), pred="lt",
                   device=dev),
        "ht": HalfTreeDpf(BITS, groups.Uint(64), ChaCha(1, NONCE),
                          hash_key=HASH_KEY, device=dev),
        "grotto": GrottoDcf(BITS, ChaCha(2, NONCE), device=dev),
        "vdpf": Vdpf(BITS, groups.Bytes(), ChaCha(2, NONCE),
                     hashes=Blake3(IV), device=dev),
        "pir": Dpf(BITS, groups.Uint(32), ChaCha(2, NONCE), device=dev),
        "batch": Dpf(BITS, groups.Uint(32), ChaCha(2, NONCE), device=dev),
        "vdmpf": Vdmpf(VDMPF_BITS, group=groups.Uint(64),
                       prg=ChaCha(2, NONCE), hashes=Blake3(IV), device=dev),
    }


def _np(t) -> np.ndarray:
    return blk.to_numpy(t)


def make_keys(seed: int = 0x5EED) -> dict:
    """Every key and input of the ranks, as numpy uint32 words (VDMPF keys
    as ``interop.vdmpf_key_to_jax`` tuples), from the port's Gen on the
    CPU."""
    rng = np.random.default_rng(seed)
    S = schemes("cpu")
    s0s = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
    beta = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    K = {"s0s": s0s, "beta": beta,
         "dpf": _np(S["dpf"].gen(s0s, ALPHA, beta)),
         "dcf": _np(S["dcf"].gen(s0s, ALPHA, beta)),
         "grotto": _np(S["grotto"].gen(s0s, GROTTO_ALPHA)),
         "pir": _np(S["pir"].gen(s0s, PIR_INDEX, (1, 0, 0, 0))),
         "db": rng.integers(0, 2**32, size=(1 << BITS, PIR_WORDS),
                            dtype=np.uint32)}
    K["ht"] = tuple(_np(x) for x in S["ht"].gen(s0s, ALPHA, beta))
    vs0s, *vkey = S["vdpf"].gen_retry(rng, VDPF_ALPHA, beta)
    K["vdpf_s0s"], K["vdpf"] = _np(vs0s), tuple(_np(x) for x in vkey)
    n = BATCH
    K["batch_s0s"] = rng.integers(0, 2**32, size=(n, 2, 4), dtype=np.uint32)
    K["batch_alphas"] = rng.integers(0, 2**BITS, size=n, dtype=np.uint32)
    K["batch_betas"] = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    K["batch"] = _np(S["batch"].gen_batch(K["batch_s0s"], K["batch_alphas"],
                                          K["batch_betas"]))
    K["mesh_s0s"] = rng.integers(0, 2**32, size=(MESH_KEYS, 2, 4),
                                 dtype=np.uint32)
    K["mesh_cws"] = _np(S["dpf"].gen_batch(
        K["mesh_s0s"], rng.integers(0, 2**BITS, size=MESH_KEYS),
        rng.integers(0, 2**32, size=(MESH_KEYS, 4), dtype=np.uint32)))
    alphas = sorted(rng.choice(1 << VDMPF_BITS, size=30,
                               replace=False).tolist())
    betas = np.zeros((30, 4), np.uint32)
    betas[:, 0] = rng.integers(0, 2**31, size=30)
    K["vdmpf_alphas"], K["vdmpf_betas"] = alphas, betas
    K["vdmpf"] = [(k.sigma, k.m_rt, k.b_size_rt,
                   *(_np(getattr(k, f)) for f in ("s0", "cws", "cs", "ocw")))
                  for k in S["vdmpf"].gen_retry(rng, alphas, betas)]
    K["vdmpf_xs"] = np.asarray(alphas[:10] + [3, 5, 9], np.uint32)  # 13
    tiny = Dpf(TINY_BITS, groups.Uint(64), ChaCha(2, NONCE), device="cpu")
    K["tiny"] = _np(tiny.gen(s0s, 3, beta))
    return K


def vdmpf_key(k, dev) -> tvdmpf.VdmpfKey:
    return tvdmpf.VdmpfKey(k[0], k[1], k[2],
                           *(blk.words(a, dev) for a in k[3:]))


def _domain_paths(S, K, m, dev) -> dict:
    """Every domain-sharded function on mesh ``m``'s "domain" axis, both
    parties: {(scheme, party): this rank's numpy outputs}."""
    out = {}
    r = m.get_local_rank("domain")
    rows = (1 << BITS) // m.size(m.mesh_dim_names.index("domain"))
    db = blk.words(K["db"][r * rows:(r + 1) * rows], dev)
    for p in (0, 1):
        s0 = K["s0s"][p]
        d = S["dpf"]
        out["dpf", p] = pm.dpf_eval_all_sharded(
            d.prg, d.group, BITS, p, s0, K["dpf"], m).to_local()
        d = S["dcf"]
        out["dcf", p] = pm.dcf_eval_all_sharded(
            d.prg, d.group, BITS, p, s0, K["dcf"], m).to_local()
        d = S["ht"]
        out["ht", p] = pm.half_tree_eval_all_sharded(
            d.prg, d.group, BITS, p, d.hash_key, s0, *K["ht"],
            m).to_local()
        d = S["grotto"]
        out["grotto", p] = pm.grotto_eval_all_sharded(
            d.prg, BITS, p, s0, K["grotto"], m).to_local()
        d = S["vdpf"]
        ys, pi = pm.vdpf_eval_all_sharded(
            d.prg, d.hashes, d.group, BITS, p, K["vdpf_s0s"][p], *K["vdpf"],
            m)
        out["vdpf", p] = (ys.to_local(), pi)
        out["pir", p] = pm.pir_lookup_sharded(
            S["pir"].prg, BITS, p, s0, K["pir"], db, m)
    return out


def _data_paths(S, K, m, dev) -> dict:
    """The data-sharded paths on mesh ``m``'s "data" axis, both parties:
    the VDMPF's BatchEval and a DPF key batch's Eval through
    :func:`shard_batch`."""
    out = {}
    v = S["vdmpf"]
    d = S["batch"]
    cws = pm.shard_batch(m, K["batch"])
    xs = pm.shard_batch(m, K["batch_alphas"])
    for p in (0, 1):
        ys, pi = pm.vdmpf_batch_eval_sharded(
            v.prg, v.hashes, v.group, VDMPF_BITS, v.bucket_bits, p,
            vdmpf_key(K["vdmpf"][p], dev), K["vdmpf_xs"], m)
        out["vdmpf", p] = (ys.to_local(), pi, tuple(ys.shape))
        s0 = pm.shard_batch(m, K["batch_s0s"][:, p])
        out["batch", p] = d.eval(p, s0.to_local(), cws.to_local(),
                                 xs.to_local())
    return out


def run_all(rank: int, world: int, K: dict, device_type: str) -> dict:
    """Every function of ``parallel.mesh`` on this rank (world = 4):
    {path: this rank's outputs as numpy words}, with its coordinates,
    the 2D EvalAll's placements and global shape, and the launch counts
    of the kernels it ran (on the card)."""
    assert world == 4
    torch.set_num_threads(1)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    S = schemes(dev)
    _build.reset_launches()
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    m22 = pm.make_multihost_mesh(("data", "domain"), device_type)
    meshes = {2: m22, 4: pm.make_mesh(axis_names=("domain",),
                                      device_type=device_type)}
    data = {2: m22, 4: pm.make_mesh(axis_names=("data",),
                                    device_type=device_type)}
    out = {"coord": tuple(m22.get_coordinate())}
    for c in SHARDS:
        out["domain", c] = _domain_paths(S, K, meshes[c], dev)
        out["data", c] = _data_paths(S, K, data[c], dev)
    # 2 x 2: a batch of keys on "data", each key's domain on "domain".
    d = S["dpf"]
    cws = pm.shard_batch(m22, K["mesh_cws"])
    for p in (0, 1):
        s0 = pm.shard_batch(m22, K["mesh_s0s"][:, p])
        ys = pm.dpf_eval_all_sharded(d.prg, d.group, BITS, p, s0, cws, m22)
        out["mesh2d", p] = ys.to_local()
    out["mesh2d_layout"] = ([str(x) for x in ys.placements], tuple(ys.shape))
    out["replicated"] = pm.replicate(
        m22, np.full(3, 1000 + rank, np.uint32)).to_local()
    g = groups.Uint(32)
    mine = g.from_block(blk.words([[rank + 1, 0, 0, 0]], dev))
    out["psum"] = pm.reconstruct_uint_psum(g, mine, meshes[4], "domain")
    out["tiny"] = [pm.dpf_eval_all_sharded(
        d.prg, d.group, TINY_BITS, p, K["s0s"][p], K["tiny"],
        meshes[4]).to_local() for p in (0, 1)]
    out["launches"] = {k: v for k, v in _build.launches.items() if v}
    return _to_numpy(out)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return _np(x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(v) for v in x)
    return x
