"""Mesh-level parallelism on torch.distributed: sharded full-domain
evaluation and key batches.

Counterpart of ``fss_tpu.parallel.mesh``, with a ``DeviceMesh`` (from
:func:`make_mesh`, :func:`make_multihost_mesh` or
``torch.distributed.device_mesh.init_device_mesh``) in place of the JAX
mesh. Every rank of the mesh calls each function with the same arguments
(SPMD), as every device runs a JAX ``shard_map`` body. Two axes:

  - ``data``: independent keys or points shard on their leading axis
    (:func:`shard_batch`); each rank runs the port's kernels on its
    ``.to_local()`` slice.
  - ``domain``: the full-domain expansion of one key. Rank r of 2^k
    shards returns its leaves [r 2^(n-k), (r+1) 2^(n-k)): the EvalAll
    kernels' top launch runs whole on every rank (its 2^K subtree roots
    are a few hundred KB), and the body launch expands only the rank's
    2^(K-k) roots (``ops/eval_all_cuda.py:shard_plan``).

Sharded outputs are ``DTensor``s sharded on the axis's mesh dimension
(``Shard(0)``; a batch of keys on a data x domain mesh ``Shard(0)`` on
data, ``Shard(1)`` on domain) and replicated on the others, the
counterpart of the JAX outputs' ``NamedSharding``; ``.to_local()`` is the
rank's part. Replicated results (the PIR answer share, the proofs) are
plain tensors, the same on every rank.

The collectives (an ``all_gather`` of a few words a shard, an
``all_reduce`` of the PIR partials) go through ``torch.distributed`` on the
axis's process group, whatever its backend: NCCL for one rank a card, or
gloo, which takes the CUDA tensors of several ranks sharing one card.
Devices and backends are the caller's: nothing here switches either.

Cross-party reconstruction stays out of band, as in the JAX package
(:func:`reconstruct_uint_psum` is for tests).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.ops import eval_all_cuda, vdpf_cuda
from fss_tpu_torch.schemes import grotto_dcf as _grotto
from fss_tpu_torch.schemes import vdmpf as _vdmpf
from fss_tpu_torch.schemes import vdpf as _vdpf


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def make_mesh(n_devices: int | None = None, axis_names=("data",),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of the world's ranks: [n_devices] on the first axis, 1 on
    the others (n_devices: the world size, the default). Every rank calls
    it after ``torch.distributed.init_process_group``, whose backend the
    mesh's groups take."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the world's {world} ranks, got "
                         f"n_devices = {n}")
    shape = (n,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def make_multihost_mesh(axis_names=("data", "domain"),
                        device_type: str = "cuda") -> DeviceMesh:
    """A mesh for a job on several hosts: the hosts on the FIRST axis and
    each host's ranks on the second, so that the domain axis's collectives
    stay inside a host and only the data axis crosses hosts. torchrun
    numbers ranks host by host (rank = node_rank * nproc_per_node +
    local_rank), so rows of the mesh are hosts; the ranks a host takes
    from ``LOCAL_WORLD_SIZE`` (torchrun sets it), else its CUDA device
    count (the world, for "cpu"). Example on 4 hosts x 8 cards:
    ``DeviceMesh("cuda", [[0..7], ..., [24..31]], ("data", "domain"))``."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if device_type == "cuda" else world)
    if world % per_host:
        raise ValueError(f"{world} ranks do not fill hosts of {per_host}")
    if len(axis_names) == 1:
        shape = (world,)
    else:
        shape = (world // per_host, per_host) + (1,) * (len(axis_names) - 2)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}: {names}")
    return names.index(axis)


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _key(t, dev) -> torch.Tensor:
    """A key's int32 words (a tensor, DTensor or array) on ``dev``."""
    return blk.block(_local(t), dev).contiguous()


def _shard_of(mesh: DeviceMesh, axis: str):
    """(r, 2^k): this rank's shard of ``axis``."""
    return mesh.get_local_rank(axis), mesh.size(_dim(mesh, axis))


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str):
    """[count, *t.shape]: t of every rank of ``axis``, in shard order."""
    parts = [torch.empty_like(t) for _ in range(mesh.size(_dim(mesh, axis)))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.stack(parts)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def data_sharding(mesh: DeviceMesh, axis: str = "data"):
    """Placements of a tensor sharded on its leading axis over ``axis`` and
    replicated on the mesh's other axes."""
    _dim(mesh, axis)
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def shard_batch(mesh: DeviceMesh, arr, axis: str = "data") -> DTensor:
    """A [B, ...] batch (the same on every rank: an int32 tensor or an
    array of 32-bit words) as a DTensor sharded on its leading axis: this
    rank keeps its B / count rows, on the mesh's device."""
    t = blk.words(_local(arr))
    r, count = _shard_of(mesh, axis)
    if t.shape[0] % count:
        raise ValueError(f"a batch of {t.shape[0]} does not split into "
                         f"{count} shards")
    rows = t.shape[0] // count
    local = t[r * rows:(r + 1) * rows].to(_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, data_sharding(mesh, axis),
                              run_check=False)


def replicate(mesh: DeviceMesh, arr) -> DTensor:
    """``arr`` as rank 0 of the mesh holds it, on every rank: a broadcast
    along each mesh axis in turn from its first rank. Every rank passes an
    array of the same shape."""
    t = blk.words(_local(arr)).to(_device(mesh)).contiguous().clone()
    for d in range(mesh.ndim):
        dist.broadcast(t, group=mesh.get_group(d), group_src=0)
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# Domain-sharded EvalAll
# ---------------------------------------------------------------------------

def _shard_leaves(in_bits: int, shard, fn, *args):
    """``fn(*args, shard=shard)``: an EvalAll of ``eval_all_cuda`` (a
    tensor or a tuple of them) over a domain of in_bits, this rank's
    shard. The kernels' plan needs k < in_bits: at one leaf a shard (k =
    in_bits), the whole domain's, sliced."""
    r, count = shard
    if count != 1 << in_bits:
        return fn(*args, shard=shard)
    out = fn(*args)
    return (tuple(x[r:r + 1] for x in out) if isinstance(out, tuple)
            else out[r:r + 1])


def _sharded(local: torch.Tensor, mesh: DeviceMesh, axis: str) -> DTensor:
    return DTensor.from_local(local, mesh, data_sharding(mesh, axis),
                              run_check=False)


def dpf_eval_all_sharded(prg2, group, in_bits: int, party: int, s0, cws,
                         mesh: DeviceMesh, axis: str = "domain") -> DTensor:
    """Full-domain DPF evaluation sharded over the mesh ``axis``: this
    rank's [2^(in_bits-k), 4] shares of 2^k shards, as a DTensor of
    [2^in_bits, 4] (``Shard(0)`` on ``axis``).

    A batch of keys, s0 [B, 4] and cws [B, in_bits+1, 8], each as a plain
    tensor (every rank evaluates all B) or a DTensor from
    :func:`shard_batch` (this rank evaluates its rows), gives
    [B_local, 2^(in_bits-k), 4], sharded on dim 1 over ``axis`` and as
    the keys on the other axes: on a ("data", "domain") mesh
    ``(Shard(0), Shard(1))``.
    """
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0_l, cws_l = _key(s0, dev), _key(cws, dev)

    def one(s, c):
        return _shard_leaves(in_bits, shard, eval_all_cuda.eval_all, prg2,
                             group, in_bits, party, s, c)

    if s0_l.dim() == 1:
        return _sharded(one(s0_l, cws_l), mesh, axis)
    ys = torch.stack([one(s, c) for s, c in zip(s0_l, cws_l)])
    keys = (s0.placements if isinstance(s0, DTensor)
            else [Replicate()] * mesh.ndim)
    return DTensor.from_local(
        ys, mesh, [Shard(1) if name == axis else keys[d]
                   for d, name in enumerate(mesh.mesh_dim_names)],
        run_check=False)


def pir_lookup_sharded(prg2, in_bits: int, party: int, s0, cws, db,
                       mesh: DeviceMesh, axis: str = "domain"):
    """One two-server PIR answer share over a domain-sharded database.

    ``db`` is this rank's rows of the [2^in_bits, D] int32 database,
    [2^(in_bits-k), D] (or a DTensor sharded on its leading axis over
    ``axis``); the DPF key encodes beta = (1, 0, 0, 0) at the private
    index. Each rank expands its shard of the selector shares (Uint(32)),
    contracts them against its rows with int32 wraparound (multiplication
    distributes over additive shares mod 2^32), and one ``all_reduce`` over
    ``axis`` adds the partials. The partials travel as int64 values below
    2^32, added exactly and then taken mod 2^32, so no backend's int32
    overflow is relied on. Returns the [D] int32 answer share, the same on
    every rank; the rows never move.
    """
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0, cws = _key(s0, dev), _key(cws, dev)
    ys = _shard_leaves(in_bits, shard, eval_all_cuda.eval_all, prg2,
                       groups.Uint(32), in_bits, party, s0, cws)
    db_l = _local(db)
    if (db_l.dim() != 2 or db_l.shape[0] != ys.shape[0]
            or db_l.dtype != torch.int32 or db_l.device != dev):
        raise ValueError(f"db must be this rank's [{ys.shape[0]}, D] int32 "
                         f"rows on {dev}, got {tuple(db_l.shape)} "
                         f"{db_l.dtype} on {db_l.device}")
    part = (ys[:, 0:1] * db_l).sum(0, dtype=torch.int64) & blk.MASK32
    dist.all_reduce(part, group=mesh.get_group(axis))
    return blk.i32(part)


def dcf_eval_all_sharded(prg4, group, in_bits: int, party: int, s0, cws,
                         mesh: DeviceMesh, axis: str = "domain") -> DTensor:
    """Full-domain DCF evaluation sharded over ``axis``: the value
    accumulator threads through the top launch into each shard's body
    (the DCF kernel's shard reads its roots' accumulators)."""
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0, cws = _key(s0, dev), _key(cws, dev)
    return _sharded(_shard_leaves(in_bits, shard, eval_all_cuda.dcf_eval_all,
                                  prg4, group, in_bits, party, s0, cws),
                    mesh, axis)


def grotto_eval_all_sharded(prg2, in_bits: int, party: int, s0, cws,
                            mesh: DeviceMesh,
                            axis: str = "domain") -> DTensor:
    """Sharded Grotto full-domain comparison shares (int32 0/1): the
    shard's leaf control bits and their prefix XOR (``cumsum(t) & 1``),
    then an ``all_gather`` of the shard totals and the XOR of the lower
    shards' (the running XOR of grotto_dcf.cuh:160-162 distributed)."""
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0, cws = _key(s0, dev), _key(cws, dev)
    _, t = _shard_leaves(in_bits, shard, eval_all_cuda.expand_leaves, prg2,
                         in_bits, party, s0, cws[:in_bits])
    local = _grotto.prefix_scan(t)
    totals = _all_gather(local[-1:], mesh, axis).reshape(-1)
    offset = (totals[:shard[0]].sum() & 1).to(torch.int32)
    return _sharded(local ^ offset, mesh, axis)


def half_tree_eval_all_sharded(prg1, group, in_bits: int, party: int,
                               hash_key, s0, cws, ocw, mesh: DeviceMesh,
                               axis: str = "domain") -> DTensor:
    """Sharded Half-Tree full-domain evaluation: the top launch to the
    shard roots, the shard's body to level n-1 and its conversion level
    (half_tree_dpf.cuh:241-276 on the mesh). Needs 2^k < 2^in_bits shards,
    a level of the shard's own before the conversion."""
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0, cws, ocw = (_key(x, dev) for x in (s0, cws, ocw))
    return _sharded(eval_all_cuda.ht_eval_all(
        prg1, group, in_bits, party, hash_key, s0, cws, ocw, shard=shard),
        mesh, axis)


def vdpf_eval_all_sharded(prg2, hashes, group, in_bits: int, party: int,
                          s0, cws, cs, ocw, mesh: DeviceMesh,
                          axis: str = "domain"):
    """Sharded VDPF full-domain evaluation and proof: (ys, a DTensor of
    [2^in_bits, 4] shares sharded on ``axis``, pi [4, 4] on every rank).
    ``hashes``: ``hash.Blake3`` or ``hash.Sha256`` (the JAX function's
    ``xor_hash`` and ``hash64``).

    Shares and pi~ are the shard's own (its points x from r 2^(n-k) on);
    the order-dependent proof fold (vdpf.cuh:253-263) is the JAX package's
    two-level chain: each shard's flat chain over its points in index
    order from cs, then a flat chain from cs over the ``all_gather``ed
    shard proofs in shard order, both through the hash's chain kernel.
    Both parties compute the same structure, which is all Verify needs;
    the proof depends on the shard count, and differs from the
    single-device fold (``api.Vdpf.eval_all``) by design.
    """
    dev = _device(mesh)
    shard = _shard_of(mesh, axis)
    s0, cws, cs, ocw = (_key(x, dev) for x in (s0, cws, cs, ocw))
    s, t = _shard_leaves(in_bits, shard, eval_all_cuda.expand_leaves, prg2,
                         in_bits, party, s0, cws)

    def two_level(pts, c):
        pi = vdpf_cuda.prove(hashes, pts, c)
        return vdpf_cuda.prove(hashes, _all_gather(pi, mesh, axis), c)

    ys, pi = _vdpf.leaf_outputs(
        lambda a, b: vdpf_cuda.xor_hash(hashes, a, b), two_level, group,
        party, s, t, cs, ocw, base=shard[0] * s.shape[0])
    return _sharded(ys, mesh, axis), pi


def _points(xs, in_bits: int, dev) -> torch.Tensor:
    """Points as ``api.Vdmpf.batch_eval`` takes them: [eta] words for
    in_bits <= 32 given as a flat array, else [eta, 4] lanes."""
    xs = _local(xs)
    if in_bits <= 32 and np.ndim(xs) == 1:
        return blk.words(xs, dev)
    return blk.pack_inputs(xs, in_bits, dev).reshape(-1, 4)


def vdmpf_batch_eval_sharded(prg2, hashes, group, in_bits: int,
                             bucket_bits: int, party: int,
                             key: _vdmpf.VdmpfKey, xs, mesh: DeviceMesh,
                             axis: str = "data", kappa: int = _vdmpf.KAPPA):
    """Data-sharded VDMPF BatchEval: (ys, a DTensor of [eta, 4] sharded on
    ``axis``, pi [4, 4] on every rank). ``xs``: all eta points, the same on
    every rank; the key (both parties' sigma is public) is replicated.

    xs is padded with zeros to a multiple of the shard count and this
    rank evaluates its slice with ``schemes.vdmpf.batch_eval``'s tree fold
    (the route, inner-eval and hash kernels). The shard proofs are
    ``all_gather``ed and chained in shard order from zero (pi[:2] ^=
    H'(pi ^ pi_shard), the hash's chain kernel). The padded points are
    dropped from ys (the last shards hold fewer rows, as ``torch.chunk``
    splits) but fold into their shard's proof, so the proof depends on
    the shard count and the padding: both parties on the same mesh shape
    agree, which is what Verify checks, but it is not byte-comparable to
    the unsharded fold (``api.Vdmpf.batch_eval``) or another mesh shape.
    """
    dev = _device(mesh)
    r, count = _shard_of(mesh, axis)
    x = _points(xs, in_bits, dev)
    eta = x.shape[0]
    rows = -(-eta // count)
    pad = torch.zeros((rows * count - eta, *x.shape[1:]), dtype=x.dtype,
                      device=dev)
    x_l = torch.cat([x, pad])[r * rows:(r + 1) * rows].contiguous()
    key = key._replace(**{f: _key(getattr(key, f), dev)
                          for f in ("s0", "cws", "cs", "ocw")})
    ys, pi = _vdmpf.batch_eval(prg2, hashes, group, in_bits, bucket_bits,
                               party, key, x_l, kappa, "tree",
                               _vdmpf.key_prp(key, in_bits, kappa))
    merged = vdpf_cuda.prove(hashes, _all_gather(pi, mesh, axis),
                             torch.zeros((4, 4), dtype=torch.int32,
                                         device=dev))
    keep = min(rows, max(eta - r * rows, 0))
    return DTensor.from_local(ys[:keep].contiguous(), mesh,
                              data_sharding(mesh, axis), run_check=False,
                              shape=torch.Size((eta, 4)),
                              stride=(4, 1)), merged


def reconstruct_uint_psum(group, y_lanes, mesh: DeviceMesh,
                          axis: str) -> torch.Tensor:
    """Group-add ``y_lanes`` (group values) across ``axis``: an
    ``all_gather``, then a fold by ``group.add`` in shard order (for tests
    and benches; deployments reconstruct out of band)."""
    gathered = _all_gather(_local(y_lanes), mesh, axis)
    acc = gathered[0]
    for nxt in gathered[1:]:
        acc = group.add(acc, nxt)
    return acc
