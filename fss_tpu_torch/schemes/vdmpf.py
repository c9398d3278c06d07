"""Verifiable distributed multi-point function through Cuckoo hashing.

Counterpart of ``fss_tpu.schemes.vdmpf`` (the reference's vdmpf.cuh): t
point functions are Cuckoo-placed into m buckets on the host (O(t),
``schemes/cuckoo.py``), and each bucket gets an inner VDPF over a
2^bucket_bits domain. Gen runs the m inner VDPF Gens as one batch
(``vdpf_cuda.gen_batch``: the DPF Gen kernel and the XorHash kernel).
BatchEval routes all eta * kappa (x, hash function) pairs in one launch of
``csrc/feistel.cu`` (``ops/feistel_cuda.py:route``), gathers each entry's
bucket key by plain indexing, evaluates all entries in one launch of the
fused VDPF walk and hash (``vdpf_cuda.eval_points``), and folds the kappa
shares of each point. The reference drops an entry whose (bucket, index)
an earlier hash function of the same point already has; no entry is ever
such a duplicate (``ops/feistel_cuda.py`` says why), so nothing is
dropped. The JAX package's one-hot
MXU row selects and packed-plane staging are a TPU workaround and have no
counterpart here.

Key layout (vdmpf.cuh:103-120): a party's key is sigma (the PRP's seed),
the runtime m_rt and b_size_rt, and the stacked bucket keys: s0 [m, 4],
cws [m, bucket_bits, 8], cs [m, 4, 4], ocw [m, 4].

Two proof folds, which give different bytes (both parties must pick the
same one):

  - ``"tree"``: a Merkle fold over [the bucket check seeds cs [m] || the
    corrected per-point hashes in flat (omega-major, hash-function-minor)
    order], zero-padded to a power of two: one ``hash64`` launch a level;
    pi = root || zeros(2, 4);
  - ``"reference"``: the reference's chain, byte for byte
    (vdmpf.cuh:242-268): each bucket's chain from its cs over that
    bucket's entries in flat order, then a chain from zero
    over all m buckets' results. Each chain is one launch of the hash's
    chain kernel (``vdpf_cuda.prove``): at most m_rt + 1 launches; a
    bucket with no entries keeps its cs and launches nothing. The entries
    are grouped by bucket with one stable sort on the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch.ops import feistel_cuda, vdpf_cuda
from fss_tpu_torch.prp.feistel import Aes128Feistel
from fss_tpu_torch.schemes import cuckoo

KAPPA = 3
CH_LAMBDA = 80
FOLDS = ("tree", "reference")
NARROW_BITS = 29  # route's indices are words up to here, lanes above


class VdmpfKey(NamedTuple):
    """One party's VDMPF key (vdmpf.cuh:115-120)."""

    sigma: bytes             # the PRP's seed, public to both parties
    m_rt: int                # runtime bucket count
    b_size_rt: int           # runtime bucket size
    s0: torch.Tensor         # [m, 4] this party's inner seeds
    cws: torch.Tensor        # [m, bucket_bits, 8]
    cs: torch.Tensor         # [m, 4, 4]
    ocw: torch.Tensor        # [m, 4]


def gen(prg2, hashes, group, in_bits: int, bucket_bits: int,
        max_points: int, sigma, s0s: torch.Tensor, alphas, betas,
        kappa: int = KAPPA, ch_lambda: int = CH_LAMBDA,
        ch_retry: int = 1000):
    """Generate a VDMPF key pair (vdmpf.cuh:135-189).

    s0s [m, 2, 4] inner seeds, m = ch_bucket(max_points, ch_lambda);
    alphas t >= 30 Python ints; betas [t, 4]. Returns (key0, key1, fail):
    fail is True when Cuckoo insertion or an inner Gen failed, and the
    caller draws sigma and s0s anew.
    """
    t = len(alphas)
    if not 30 <= t <= max_points:
        raise ValueError(f"need 30 <= t <= max_points, got t = {t}")
    m = cuckoo.ch_bucket(max_points, ch_lambda)
    if tuple(s0s.shape) != (m, 2, 4):
        raise ValueError(f"s0s must be [{m}, 2, 4], got {tuple(s0s.shape)}")
    n = 1 << in_bits
    m_rt = cuckoo.ch_bucket(t, ch_lambda)
    b_rt = (n * kappa + m_rt - 1) // m_rt
    if m_rt > m or b_rt > 1 << bucket_bits:
        raise ValueError("bucket_bits too small for t")

    prp = Aes128Feistel(sigma, n * kappa)
    table = cuckoo.compact_run(prp, alphas, m_rt, n, b_rt, ch_retry, kappa)
    if table is None:
        return (*_zero_key(m_rt, b_rt, s0s, bucket_bits), True)

    # Each bucket's inner point: alpha' its index in the bucket, beta' the
    # payload; empty buckets take the zero function (vdmpf.cuh:164-175).
    a_prime = [0] * m  # ints: a bucket's domain may exceed 32 bits
    b_prime = torch.zeros((m, 4), dtype=torch.int32, device=s0s.device)
    betas = blk.block(betas, s0s.device)
    for i in range(m_rt):
        j, k = table[i]
        if j == -1:
            continue
        _, a_prime[i] = cuckoo.locate_host(prp, int(alphas[j]), k, n, b_rt,
                                           kappa)
        b_prime[i] = betas[j]
    a_lanes = blk.pack_inputs(a_prime, bucket_bits, s0s.device)
    cws, cs, ocw, fails = vdpf_cuda.gen_batch(prg2, hashes, group,
                                              bucket_bits, s0s, a_lanes,
                                              b_prime)
    fail = bool(fails.any())
    k0 = VdmpfKey(prp.sigma, m_rt, b_rt, s0s[:, 0].contiguous(), cws, cs,
                  ocw)
    k1 = VdmpfKey(prp.sigma, m_rt, b_rt, s0s[:, 1].contiguous(), cws, cs,
                  ocw)
    return k0, k1, fail


def _zero_key(m_rt, b_rt, s0s, bucket_bits):
    m, dev = s0s.shape[0], s0s.device
    z = torch.zeros((m, bucket_bits, 8), dtype=torch.int32, device=dev)
    zc = torch.zeros((m, 4, 4), dtype=torch.int32, device=dev)
    zo = torch.zeros((m, 4), dtype=torch.int32, device=dev)
    return tuple(VdmpfKey(bytes(16), m_rt, b_rt, s0s[:, p].contiguous(), z,
                          zc, zo) for p in (0, 1))


def key_prp(key: VdmpfKey, in_bits: int,
            kappa: int = KAPPA) -> Aes128Feistel:
    """The key's PRP, over 2^in_bits * kappa."""
    return Aes128Feistel(key.sigma, (1 << in_bits) * kappa)


def route(key: VdmpfKey, in_bits: int, xs: torch.Tensor,
          kappa: int = KAPPA, prp: Aes128Feistel | None = None):
    """Batched Locate: xs [eta] int32 words or [eta, 4] lanes ->
    (bucket [eta, kappa] int32, index). The index is [eta, kappa] int32
    words for in_bits <= 29, else [eta, kappa, 4] lanes, as the JAX
    package returns it. ``prp``: the key's (:func:`key_prp`), made here
    when not given.

    The PRP runs on the eta * kappa values themselves, not through a
    tabulated permutation (``ops/feistel_cuda.py`` says why)."""
    n = 1 << in_bits
    if prp is None:
        prp = key_prp(key, in_bits, kappa)
    return feistel_cuda.route(prp, n, kappa, key.b_size_rt, xs,
                              1 if in_bits <= NARROW_BITS else 4)


def check_points(xs: torch.Tensor, in_bits: int) -> None:
    """Raise unless every point of xs ([eta] words or [eta, 4] lanes) is
    below 2^in_bits."""
    x = blk.u64(xs).reshape(xs.shape[0], -1)
    room = torch.tensor([min(max(in_bits - 32 * i, 0), 32)
                         for i in range(x.shape[1])], device=xs.device)
    if bool((x >> room).any()):
        raise ValueError(f"every point must be below 2^{in_bits}")


def batch_eval(prg2, hashes, group, in_bits: int, bucket_bits: int,
               party: int, key: VdmpfKey, xs: torch.Tensor,
               kappa: int = KAPPA, fold: str = "tree",
               prp: Aes128Feistel | None = None):
    """Verifiable batch evaluation (vdmpf.cuh:202-270) at points below
    2^in_bits; a point at or above it raises ValueError. Returns (ys
    [eta, 4], pi [4, 4]). ``prp`` as for :func:`route`."""
    if fold not in FOLDS:
        raise ValueError(f"fold must be one of {FOLDS}, got {fold!r}")
    check_points(xs, in_bits)
    bucket, index = route(key, in_bits, xs, kappa, prp)
    b = bucket.reshape(-1).long()                       # [E]
    if index.dim() == 3:  # lanes: words for a bucket domain of 32 bits
        j = (index[..., 0].reshape(-1) if bucket_bits <= 32
             else index.reshape(-1, 4))
    else:
        j = index.reshape(-1)
    # Every entry's inner VDPF eval, entry e reading bucket b[e]'s key.
    ys_e, pt_e = vdpf_cuda.eval_points(prg2, hashes, group, bucket_bits,
                                       party, key.s0[b], key.cws[b],
                                       key.cs[b], key.ocw[b], j.contiguous())

    ys = group_fold(group, ys_e, kappa)
    if fold == "reference":
        return ys, reference_fold(hashes, key.cs, b, pt_e)
    return ys, tree_fold(hashes, key.cs, pt_e)


def group_fold(group, ys_e: torch.Tensor, kappa: int) -> torch.Tensor:
    """Each point's share: the group sum of its kappa entries' shares
    ys_e [E, 4] (the group is commutative, so the order is free). Returns
    [E / kappa, 4]."""
    yv = group.from_block(ys_e).reshape(-1, kappa, 4)
    acc = yv[:, 0]
    for k in range(1, kappa):
        acc = group.add(acc, yv[:, k])
    return group.into_block(acc)


def tree_fold(hashes, cs: torch.Tensor, pt_e: torch.Tensor) -> torch.Tensor:
    """The Merkle fold of [cs || pi~], zero-padded to a power of two (at
    least 2): one ``hash64`` launch a level; pi = root || zeros(2, 4)."""
    total = cs.shape[0] + pt_e.shape[0]
    size = 1 << max(1, (total - 1).bit_length())
    leaves = torch.zeros((size, 4, 4), dtype=torch.int32, device=cs.device)
    leaves[:cs.shape[0]] = cs
    leaves[cs.shape[0]:total] = pt_e
    h = vdpf_cuda.hash64(hashes, leaves)                 # [size, 2, 4]
    while h.shape[0] > 1:
        h = vdpf_cuda.hash64(hashes, h.reshape(-1, 4, 4))
    return torch.cat([h[0], torch.zeros((2, 4), dtype=torch.int32,
                                        device=cs.device)])


def reference_fold(hashes, cs: torch.Tensor, b: torch.Tensor,
                   pt_e: torch.Tensor) -> torch.Tensor:
    """The reference's chain fold, byte for byte (vdmpf.cuh:242-268).

    Bucket b's proof starts at cs[b] and folds in its entries in flat
    order (pb[:2] ^= H'(pb ^ pi~)); then pi starts at zero and folds in
    every bucket's proof, empty buckets included. The entries are grouped
    by one stable sort by bucket, so each bucket's chain is one
    ``vdpf_cuda.prove`` over a slice of them.
    """
    m = cs.shape[0]
    order = torch.sort(b, stable=True).indices
    counts = torch.bincount(b, minlength=m).tolist()
    pts = pt_e[order]
    pbs, start = [], 0
    for bucket, count in enumerate(counts):
        pbs.append(vdpf_cuda.prove(hashes, pts[start:start + count],
                                   cs[bucket]) if count else cs[bucket])
        start += count
    return vdpf_cuda.prove(hashes, torch.stack(pbs),
                           torch.zeros((4, 4), dtype=torch.int32,
                                       device=cs.device))


def verify(pi0: torch.Tensor, pi1: torch.Tensor) -> bool:
    """64-byte proof equality."""
    return bool(torch.equal(pi0, pi1))
