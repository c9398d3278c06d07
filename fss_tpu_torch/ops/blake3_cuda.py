"""Keyed BLAKE3 on the card: wrappers of the CUDA kernels of
``csrc/blake3.cu``.

Counterpart of ``fss_tpu.ops.blake3_pallas``. The kernels replace
``blake3_pallas.xor_hash_planes`` (H, :func:`xor_hash`) and
``blake3_pallas.hash64_batch`` (H', :func:`hash64`); :func:`chain` runs the
VDPF's flat proof fold, ``schemes/vdpf.py:prove`` (the JAX package's
``lax.scan``), in one CTA: four lanes of one warp share each compression,
fed by a producer warp through a ring of ``CHAIN_RING`` slots in shared
memory (``csrc/ring.cuh``). The source file says what bounds each kernel
on the H100 and what its design does about that.

Dispatch is by the tensors' device only: CUDA tensors go to the kernel
(a failing build or launch raises), CPU tensors to the plain PyTorch
version beside each wrapper (``*_plain``), which computes the same
function with ``hash/blake3.py:compress_words`` (the chain's on Python
ints, one point at a time) and is what the CPU tests and the card's
kernel checks compare with. Rows are int32: H takes
a, b [N, 4] and returns [N, 4, 4]; H' takes [N, 4, 4] and returns
[N, 2, 4]. The IV reaches the kernels as 8 uint32 arguments.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.block import i32, u64
from fss_tpu_torch.hash import blake3 as _b3
from fss_tpu_torch.ops.dpf_cuda import _device
from fss_tpu_torch.schemes import vdpf as _vdpf

_XOR_ARGS = (_build.P, _build.P, _build.P, _build.I64, *(_build.U32,) * 8,
             _build.P)
_H64_ARGS = (_build.P, _build.P, _build.I64, *(_build.U32,) * 8, _build.P)
_CHAIN_ARGS = (_build.P, _build.P, _build.P, _build.I64,
               *(_build.U32,) * 8, _build.P)
CHAIN_RING = 8  # the chain kernel's ring slots (kRing in csrc/blake3.cu)


def check_xor_hash(a, b) -> torch.device:
    """Raise unless a, b are int32 [N, 4] rows on one device."""
    dev = _device(a, b)
    _build.check(a, "a", dev, [(b.shape[0], 4)])
    _build.check(b, "b", dev, [(a.shape[0], 4)])
    return dev


def check_hash64(msg) -> torch.device:
    dev = _device(msg)
    _build.check(msg, "msg", dev, [(msg.shape[0], 4, 4)])
    return dev


def check_chain(pts, cs) -> torch.device:
    dev = _device(pts, cs)
    _build.check(pts, "pi_tildes", dev, [(pts.shape[0], 4, 4)])
    _build.check(cs, "cs", dev, [(4, 4)])
    return dev


def xor_hash(iv, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) of each row: a, b [N, 4] -> [N, 4, 4] (blake3.cuh)."""
    dev = check_xor_hash(a, b)
    if dev.type == "cpu":
        return xor_hash_plain(iv, a, b)
    n = a.shape[0]
    out = torch.empty((n, 4, 4), dtype=torch.int32, device=dev)
    fn = _build.function("blake3", "fss_blake3_xor_hash", _XOR_ARGS)
    _build.launch("blake3", fn, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  n, *blk.key_words(iv, 8, "iv"), device=dev,
                  kernel="blake3_xor_hash")
    return out


def xor_hash_plain(iv, a, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`xor_hash`, on any device."""
    check_xor_hash(a, b)
    iv = blk.key_words(iv, 8, "iv")
    ua, ub = u64(a), u64(b)
    pad = [torch.zeros_like(ua[:, 0])] * 8
    words = []
    for lsb in (0, 1):
        m = [ua[:, 0], ua[:, 1], ua[:, 2], (ua[:, 3] & ~1) | lsb,
             *ub.unbind(1), *pad]
        words += _b3.compress_words(iv, m, 32)[:8]
    return i32(torch.stack(words, dim=1)).reshape(-1, 4, 4)


def hash64(iv, msg: torch.Tensor) -> torch.Tensor:
    """H'(msg) of each row: [N, 4, 4] -> [N, 2, 4]."""
    dev = check_hash64(msg)
    if dev.type == "cpu":
        return hash64_plain(iv, msg)
    n = msg.shape[0]
    out = torch.empty((n, 2, 4), dtype=torch.int32, device=dev)
    fn = _build.function("blake3", "fss_blake3_hash64", _H64_ARGS)
    _build.launch("blake3", fn, msg.data_ptr(), out.data_ptr(), n,
                  *blk.key_words(iv, 8, "iv"), device=dev,
                  kernel="blake3_hash64")
    return out


def hash64_plain(iv, msg) -> torch.Tensor:
    """Plain PyTorch version of :func:`hash64`, on any device."""
    check_hash64(msg)
    m = u64(msg).reshape(-1, 16).unbind(1)
    out = _b3.compress_words(blk.key_words(iv, 8, "iv"), m, 64)[:8]
    return i32(torch.stack(out, dim=1)).reshape(-1, 2, 4)


def chain(iv, pts: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """The flat proof fold over pi_tildes [N, 4, 4] from cs [4, 4]: pi
    starts at cs and each row folds in as pi[:2] ^= H'(pi ^ pi~_i).
    Returns [4, 4]."""
    dev = check_chain(pts, cs)
    if dev.type == "cpu":
        return chain_plain(iv, pts, cs)
    out = torch.empty((4, 4), dtype=torch.int32, device=dev)
    fn = _build.function("blake3", "fss_blake3_chain", _CHAIN_ARGS)
    _build.launch("blake3", fn, pts.data_ptr(), cs.data_ptr(),
                  out.data_ptr(), pts.shape[0], *blk.key_words(iv, 8, "iv"),
                  device=dev, kernel="blake3_chain")
    return out


def chain_plain(iv, pts, cs) -> torch.Tensor:
    """Plain version of :func:`chain`, on any device: the same fold on the
    host in Python ints (``hash/blake3.py:compress_reference``), one point
    at a time."""
    check_chain(pts, cs)
    iv = blk.key_words(iv, 8, "iv")
    return _vdpf.prove_scalar(
        lambda m: [int(w) for w in _b3.compress_reference(iv, m, 64)[:8]],
        pts, cs)
