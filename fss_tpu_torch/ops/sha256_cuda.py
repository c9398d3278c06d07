"""Keyed SHA-256 on the card: wrappers of the CUDA kernels of
``csrc/sha256.cu``.

Counterpart of ``fss_tpu.ops.sha256_pallas``. The XorHash kernel replaces
``sha256_pallas.xor_hash_planes`` (H, :func:`xor_hash`). :func:`hash64`
(H' = SHA-256(key || msg)) is the counterpart of ``Sha256.hash64``, which
the JAX package runs as XLA, and :func:`chain` of its ``lax.scan`` of H'
(``schemes/vdpf.py:prove``): the SHA-256 tree fold runs on the card as one
launch a level, and the flat chain as one CTA whose producer warps prepare
each point's chain-free work in a ring of ``CHAIN_RING`` slots in shared
memory ahead of the lane that carries pi. The source file says what bounds
each kernel on the H100.

Dispatch, shapes and plain versions as in ``ops/blake3_cuda.py``; the
plain versions call ``hash/sha256.py:compress_words``, on tensors, or on
Python ints for the chain. The key (4 little-endian lanes) reaches the
kernels as 4 uint32 arguments; the entry points turn it into the launch
constants of H' (the state after the key's rounds, the key's schedule
terms) on the host.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.block import i32, u64
from fss_tpu_torch.hash import sha256 as _sh
from fss_tpu_torch.hash.sha256 import bswap32
from fss_tpu_torch.ops.blake3_cuda import (check_chain, check_hash64,
                                           check_xor_hash)
from fss_tpu_torch.schemes import vdpf as _vdpf

_XOR_ARGS = (_build.P, _build.P, _build.P, _build.I64, *(_build.U32,) * 4,
             _build.P)
_H64_ARGS = (_build.P, _build.P, _build.I64, *(_build.U32,) * 4, _build.P)
_CHAIN_ARGS = (_build.P, _build.P, _build.P, _build.I64,
               *(_build.U32,) * 4, _build.P)
CHAIN_RING = 16  # the chain kernel's ring slots (kRing in csrc/sha256.cu)


def _hash64_words(key, m):
    """H' of one or a batch of messages: 16 lane words (int64 tensors or
    Python ints) -> the 8 digest lane words."""
    kw = [bswap32(k) for k in blk.key_words(key, 4, "key")]
    mw = [bswap32(w) for w in m]
    st = _sh.compress_words(_sh.H0, kw + mw[:12])
    st = _sh.compress_words(st, mw[12:] + list(_sh.PAD80))
    return [bswap32(w) for w in st]


def xor_hash(key, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) of each row: a, b [N, 4] -> [N, 4, 4] (sha256.cuh)."""
    dev = check_xor_hash(a, b)
    if dev.type == "cpu":
        return xor_hash_plain(key, a, b)
    n = a.shape[0]
    out = torch.empty((n, 4, 4), dtype=torch.int32, device=dev)
    fn = _build.function("sha256", "fss_sha256_xor_hash", _XOR_ARGS)
    _build.launch("sha256", fn, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  n, *blk.key_words(key, 4, "key"), device=dev,
                  kernel="sha256_xor_hash")
    return out


def xor_hash_plain(key, a, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`xor_hash`, on any device."""
    check_xor_hash(a, b)
    ua, ub = u64(a), u64(b)
    kw = [bswap32(k) for k in blk.key_words(key, 4, "key")]
    bw = [bswap32(w) for w in ub.unbind(1)]
    words = []
    for lsb in (0, 1):
        aw = [bswap32(ua[:, 0]), bswap32(ua[:, 1]), bswap32(ua[:, 2]),
              bswap32((ua[:, 3] & ~1) | lsb)]
        st = _sh.compress_words(_sh.H0, kw + aw + bw + list(_sh.PAD48))
        words += [bswap32(w) for w in st]
    return i32(torch.stack(words, dim=1)).reshape(-1, 4, 4)


def hash64(key, msg: torch.Tensor) -> torch.Tensor:
    """H'(msg) = SHA-256(key || msg) of each row: [N, 4, 4] -> [N, 2, 4]."""
    dev = check_hash64(msg)
    if dev.type == "cpu":
        return hash64_plain(key, msg)
    n = msg.shape[0]
    out = torch.empty((n, 2, 4), dtype=torch.int32, device=dev)
    fn = _build.function("sha256", "fss_sha256_hash64", _H64_ARGS)
    _build.launch("sha256", fn, msg.data_ptr(), out.data_ptr(), n,
                  *blk.key_words(key, 4, "key"), device=dev,
                  kernel="sha256_hash64")
    return out


def hash64_plain(key, msg) -> torch.Tensor:
    """Plain PyTorch version of :func:`hash64`, on any device: two blocks,
    key || msg[0:12] and msg[12:16] || the padding of 80 bytes."""
    check_hash64(msg)
    words = _hash64_words(key, u64(msg).reshape(-1, 16).unbind(1))
    return i32(torch.stack(words, dim=1)).reshape(-1, 2, 4)


def chain(key, pts: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """The flat proof fold over pi_tildes [N, 4, 4] from cs [4, 4], as
    ``blake3_cuda.chain``: one CTA, whatever N, with no scratch in device
    memory. Returns [4, 4]."""
    dev = check_chain(pts, cs)
    if dev.type == "cpu":
        return chain_plain(key, pts, cs)
    out = torch.empty((4, 4), dtype=torch.int32, device=dev)
    fn = _build.function("sha256", "fss_sha256_chain", _CHAIN_ARGS)
    _build.launch("sha256", fn, pts.data_ptr(), cs.data_ptr(),
                  out.data_ptr(), pts.shape[0], *blk.key_words(key, 4, "key"),
                  device=dev, kernel="sha256_chain")
    return out


def chain_plain(key, pts, cs) -> torch.Tensor:
    """Plain version of :func:`chain`, on any device: the same fold on the
    host in Python ints, one point at a time (torch ops on one row would
    cost ~6,000 dispatches a point)."""
    check_chain(pts, cs)
    return _vdpf.prove_scalar(lambda m: _hash64_words(key, m), pts, cs)
