"""The AES-Feistel PRP and the VDMPF's Locate on the card: wrappers of the
CUDA kernel ``csrc/feistel.cu``, and their plain PyTorch versions.

The kernel replaces XLA glue of the JAX package, no Pallas kernel:
``fss_tpu.prp.feistel.Aes128Feistel.permu`` / ``permu_lanes`` and the
Locate part of ``fss_tpu.schemes.vdmpf.route``. A point x has one value
x + n k for each hash function k: y = PRP(x + n k) over the domain
n kappa, cycle-walked, bucket = y // b_rt, index = y % b_rt. The kernel
walks one value a thread, a thread block a contiguous slice of the
values; where a Feistel half has at most 10 bits and the values are many
enough, each thread block first tabulates the four AES round functions
over every half (:func:`plan` gives the launch's thread blocks, slice
and choice). The reference's BatchEval drops a hash function whose (bucket, index) an
earlier one of the same point already has. That never happens: the kappa
values x + n k of one point are distinct and the PRP is a bijection on
its domain, so their (bucket, index) pairs are distinct, and no dup flag
is computed. A value at or above the domain (a point at or above n, or
at or above the domain for :func:`permute`) is outside the function: its
walk need not end, so it is not walked, and it gives bucket -1 and an
index of all ones (y of all ones), in the kernel and in the plain
versions alike.

The port permutes the routed values directly and does not tabulate the
permutation: the JAX package gathers from a host-made table of the whole
permutation (n kappa values, 3 * 2^16 at the bench's shape) because on a
TPU a gather is cheaper than four AES rounds of them, while here the
eta * kappa values themselves (3 * 2^14 there) take fewer passes than
the table, and both move the same bytes, the table being the
permutation. The round functions' table is another thing: 4 * 2^half
entries (2,048 at the bench), built in shared memory by each launch.
:func:`table` is the whole permutation all the same, for
``Aes128Feistel.permutation_table``.

Dispatch is by the tensors' device only: CUDA tensors go to the kernel (a
failing build or launch raises), CPU tensors to the plain versions
(:func:`route_plain`, :func:`permute_plain`, :func:`table_plain`), which
compute the same function on int64 lanes in [0, 2^32) with the port's
batched AES (``prg/aes.py:aes128_encrypt_words``), re-permuting only the
values still outside the domain. Values cross as int32 words ([N], below
2^32) or [N, 4] little-endian lanes.
"""

from __future__ import annotations

import ctypes

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.block import MASK32
from fss_tpu_torch.groups import (_add128, _const128, _ge128, _lanes,
                                  _mask_to_bits, _shl128, _shr128, _stack,
                                  _sub128)
from fss_tpu_torch.ops.dpf_cuda import _device, _x_lanes
from fss_tpu_torch.prg.aes import _bswap, aes128_encrypt_words

_ROUTE_ARGS = (_build.P, _build.INT, _build.I64, _build.INT,
               *(_build.U64,) * 6, _build.INT, _build.INT, _build.P,
               _build.P, _build.INT, _build.P, _build.P)
_PERMUTE_ARGS = (_build.P, _build.INT, _build.I64, _build.U64, _build.U64,
                 _build.INT, _build.P, _build.INT, _build.P, _build.P)


def _halves(v: int) -> tuple:
    return v & (2**64 - 1), v >> 64


def _check_xs(xs) -> torch.device:
    dev = _device(xs)
    _build.check(xs, "xs", dev, [(xs.shape[0],), (xs.shape[0], 4)])
    return dev


def _aligned(xs: torch.Tensor) -> torch.Tensor:
    """The kernel reads 4-lane points as one 16-byte load."""
    if xs.dim() == 2 and xs.data_ptr() % 16:
        return xs.clone()
    return xs


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def feistel_pass_plain(prp, v: torch.Tensor) -> torch.Tensor:
    """One pass of the 4-round network over int64 lanes [..., 4] of values
    below 2^(2 half): the round function is AES of the right half's 16
    little-endian bytes (big-endian state words: the byte-swapped lanes),
    read back little-endian and masked to ``half`` bits."""
    half = prp.half
    right = _mask_to_bits(v, half)
    left = _mask_to_bits(_stack(_shr128(_lanes(v), half)), half)
    for rk in prp.round_keys:
        out = aes128_encrypt_words(rk, [_bswap(w) for w in _lanes(right)])
        f = _mask_to_bits(_stack([_bswap(w) for w in out]), half)
        left, right = right, left ^ f
    return _stack(_shl128(_lanes(left), half)) | right


def walk_plain(prp, v: torch.Tensor):
    """The PRP of int64 lanes [..., 4], each value re-permuted until it
    lands below the domain. A value at or above the domain is not walked
    (its walk need not end) and gives all ones. Returns (y, passes),
    passes the Feistel passes the walk ran over all values."""
    lost = _ge128(v, _const128(prp.domain, v))
    y = v.clone()
    out = ~lost
    passes = 0
    while bool(out.any()):
        passes += int(out.sum())
        y[out] = feistel_pass_plain(prp, y[out])
        out = _ge128(y, _const128(prp.domain, y)) & ~lost
    y[lost] = MASK32
    return y, passes


def _divide_plain(rem: torch.Tensor, b: int, qbits: int):
    """(rem // b, rem % b) over int64 lanes for quotients below
    2^qbits, by shift-subtract: the kernel's division."""
    q = torch.zeros(rem.shape[:-1], dtype=torch.int64, device=rem.device)
    for i in range(qbits - 1, -1, -1):
        c = _const128(b << i, rem)
        ge = _ge128(rem, c)
        rem = torch.where(ge[..., None], _sub128(rem, c), rem)
        q |= ge.to(torch.int64) << i
    return q, rem


def _qbits(prp, b_rt: int) -> int:
    return ((prp.domain - 1) // b_rt).bit_length()


def _check_route(prp, n, kappa, b_rt, xs, index_lanes) -> torch.device:
    dev = _check_xs(xs)
    if kappa < 1:
        raise ValueError(f"kappa must be at least 1, got {kappa}")
    if prp.domain != n * kappa:
        raise ValueError(f"the PRP's domain {prp.domain} is not n * kappa "
                         f"= {n * kappa}")
    if not 1 <= b_rt <= prp.domain:
        raise ValueError(f"b_rt must be in 1..{prp.domain}, got {b_rt}")
    if index_lanes not in (1, 4) or (index_lanes == 1
                                     and b_rt > 2**32):
        raise ValueError(f"index_lanes {index_lanes} cannot hold indices "
                         f"below {b_rt}")
    return dev


def route_plain(prp, n: int, kappa: int, b_rt: int, xs: torch.Tensor,
                index_lanes: int):
    """Plain PyTorch version of :func:`route`, on any device."""
    _check_route(prp, n, kappa, b_rt, xs, index_lanes)
    x = blk.u64(_x_lanes(xs))
    vals = torch.stack([_add128(x, _const128(n * k, x))
                        for k in range(kappa)], dim=-2)  # [eta, kappa, 4]
    y, _ = walk_plain(prp, vals)
    lost = _ge128(vals, _const128(prp.domain, vals))
    bucket, index = _divide_plain(torch.where(lost[..., None], 0, y), b_rt,
                                  _qbits(prp, b_rt))
    bucket[lost] = -1
    index[lost] = MASK32
    index = blk.i32(index if index_lanes == 4 else index[..., 0])
    return bucket.to(torch.int32), index


def permute_plain(prp, xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`permute`, on any device."""
    _check_xs(xs)
    y, _ = walk_plain(prp, blk.u64(_x_lanes(xs)))
    return blk.i32(y if xs.dim() == 2 else y[:, 0])


def table_plain(prp, device) -> torch.Tensor:
    """Plain PyTorch version of :func:`table`, on any device."""
    x = torch.zeros((prp.domain, 4), dtype=torch.int64, device=device)
    x[:, 0] = torch.arange(prp.domain, device=device)
    return blk.i32(walk_plain(prp, x)[0][:, 0])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def route(prp, n: int, kappa: int, b_rt: int, xs: torch.Tensor,
          index_lanes: int):
    """Locate every point under every hash function.

    ``prp``: an ``Aes128Feistel`` over n * kappa; xs [eta] int32 words or
    [eta, 4] lanes of points below n. Returns (bucket [eta, kappa] int32,
    index [eta, kappa] int32 words (``index_lanes`` 1) or [eta, kappa, 4]
    lanes (4)).
    """
    dev = _check_route(prp, n, kappa, b_rt, xs, index_lanes)
    if dev.type == "cpu":
        return route_plain(prp, n, kappa, b_rt, xs, index_lanes)
    xs = _aligned(xs)
    eta = xs.shape[0]
    bucket = torch.empty((eta, kappa), dtype=torch.int32, device=dev)
    index = torch.empty((eta, kappa) + ((4,) if index_lanes == 4 else ()),
                        dtype=torch.int32, device=dev)
    launch_route(prp, n, kappa, b_rt, xs, bucket, index)
    return bucket, index


def launch_route(prp, n: int, kappa: int, b_rt: int, xs: torch.Tensor,
                 bucket: torch.Tensor, index: torch.Tensor) -> None:
    """One launch of the route kernel into preallocated outputs, as
    :func:`route` makes them (its index lanes read from ``index``'s
    shape): the wrapper's launch without its checks and allocations."""
    fn = _build.function("feistel", "fss_feistel_route", _ROUTE_ARGS)
    _build.launch(
        "feistel", fn, xs.data_ptr(), 4 if xs.dim() == 2 else 1,
        xs.shape[0], kappa, *_halves(prp.domain), *_halves(n),
        *_halves(b_rt), prp.half, _qbits(prp, b_rt), bucket.data_ptr(),
        index.data_ptr(), 4 if index.dim() == 3 else 1, prp.arg,
        device=xs.device, kernel="feistel_route")


def _permute(prp, xs, count: int, dev: torch.device, lanes: int):
    y = torch.empty((count,) + ((4,) if lanes == 4 else ()),
                    dtype=torch.int32, device=dev)
    fn = _build.function("feistel", "fss_feistel_permute", _PERMUTE_ARGS)
    _build.launch(
        "feistel", fn, None if xs is None else xs.data_ptr(),
        0 if xs is None else (4 if xs.dim() == 2 else 1), count,
        *_halves(prp.domain), prp.half, y.data_ptr(), lanes, prp.arg,
        device=dev, kernel="feistel_permute")
    return y


def permute(prp, xs: torch.Tensor) -> torch.Tensor:
    """y = PRP(x) of points below the domain: xs [N] int32 words (domain
    up to 2^32) or [N, 4] lanes; y in the same layout."""
    dev = _check_xs(xs)
    if xs.dim() == 1 and prp.domain > 2**32:
        raise ValueError("a domain above 2^32 needs [N, 4] lanes")
    if dev.type == "cpu":
        return permute_plain(prp, xs)
    xs = _aligned(xs)
    return _permute(prp, xs, xs.shape[0], dev, 4 if xs.dim() == 2 else 1)


def plan(prp, total: int, device) -> tuple:
    """The kernel's plan for ``total`` values of ``prp`` on the CUDA
    ``device``: (CTAs, values a CTA's slice, threads a CTA, 1 if the round
    functions are tabulated, else 0)."""
    fn = _build.function("feistel", "fss_feistel_plan", (
        _build.I64, _build.U64, _build.U64, _build.INT, _build.P))
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(torch.device(device)):
        rc = fn(total, *_halves(prp.domain), prp.half, out)
    if rc != 0:
        raise RuntimeError(f"fss_feistel_plan failed: CUDA error {rc}")
    return tuple(out)


def table(prp, device) -> torch.Tensor:
    """The whole permutation, [domain] int32 words: y of x = 0..domain-1,
    the kernel's threads taking x from their index (domain up to 2^32)."""
    dev = torch.device(device)
    if prp.domain > 2**32:
        raise ValueError("a table's domain must fit 32 bits")
    if dev.type == "cpu":
        return table_plain(prp, dev)
    return _permute(prp, None, prp.domain, dev, 1)
