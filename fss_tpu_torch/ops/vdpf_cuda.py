"""Batched VDPF point evaluation and Gen on the card: the fused walk+hash
kernel ``csrc/vdpf_eval.cu``, the DPF Gen kernel and the hash kernels.

Counterpart of ``fss_tpu.ops.vdpf_pallas``. The kernel replaces
``vdpf_pallas.fused_eval_packed`` with the ChaCha PRG and
``aes_pallas.vdpf_eval_points`` (the AES walk chained with the XorHash)
with AES-128-MMO; each wrapper takes the PRG object (``prg``, ChaCha or
AesMmo with mul=2): one thread a key walks the DPF tree
(``csrc/dpf_walk.cuh``, the DPF eval kernel's walk) and hashes
(x, leaf seed) in registers, with the hash a template parameter. The
t ? cs : 0 correction and the group finalize stay torch glue, as in
``vdpf_pallas.eval_points``. Gen runs the DPF Gen kernel
(``csrc/dpf_gen.cu``) for the levels, writing VDPF wire rows
[B, in_bits, 8] directly, and the XorHash kernel for the check seed cs.

Hash dispatch reads the hash object's type: ``hash.Blake3`` and
``hash.Sha256`` go to their kernels on the card and to their plain
versions on the CPU. Any other object with the same two methods runs on
the CPU only: on a CUDA tensor it raises, as there is no plain route on
the card. Dispatch of the kernels themselves is by the tensors' device,
as everywhere in ``fss_tpu_torch.ops``.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops import blake3_cuda, dpf_cuda, sha256_cuda
from fss_tpu_torch.ops.dpf_cuda import _device, _x_lanes
from fss_tpu_torch.schemes import dpf as _dpf
from fss_tpu_torch.schemes import vdpf as _vdpf

_EVAL_ARGS = (_build.P, _build.I64, _build.P, _build.I64, _build.P,
              _build.I64, _build.P, _build.P, _build.P, _build.I64,
              _build.INT, _build.INT, _build.INT, *(_build.U32,) * 8,
              _build.P, _build.P)
_BLAKE3, _SHA256 = 0, 1


def hash_kind(hashes, device) -> int | None:
    """The kernels' code of a hash object (0 BLAKE3, 1 SHA-256), or None
    for any other object, which is refused on the card."""
    if isinstance(hashes, Blake3):
        return _BLAKE3
    if isinstance(hashes, Sha256):
        return _SHA256
    if torch.device(device).type == "cuda":
        raise TypeError(f"on the card the hashes must be fss_tpu_torch."
                        f"hash.Blake3 or Sha256, got {type(hashes).__name__}")
    return None


def _kernels(hashes, device):
    """(wrapper module, IV or key) of a hash's kernels on ``device``, or
    None for a hash object of another type (CPU only)."""
    kind = hash_kind(hashes, device)
    if kind is None:
        return None
    return (blake3_cuda, hashes.iv) if kind == _BLAKE3 else (sha256_cuda,
                                                              hashes.key)


def _hash_args(hashes) -> tuple:
    """The 8 kernel words of a hash: BLAKE3's IV, or SHA-256's key and 4
    zeros."""
    if isinstance(hashes, Blake3):
        return hashes.iv
    return (*hashes.key, 0, 0, 0, 0)


def xor_hash(hashes, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) of each row, a, b [N, 4] -> [N, 4, 4], through the hash's
    kernel (its plain version on the CPU)."""
    k = _kernels(hashes, a.device)
    return k[0].xor_hash(k[1], a, b) if k else hashes.xor_hash(a, b)


def xor_hash_plain(hashes, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`xor_hash`, on any device."""
    k = _kernels(hashes, "cpu")
    return k[0].xor_hash_plain(k[1], a, b) if k else hashes.xor_hash(a, b)


def hash64(hashes, msg: torch.Tensor) -> torch.Tensor:
    """H'(msg) of each row, [N, 4, 4] -> [N, 2, 4]."""
    k = _kernels(hashes, msg.device)
    return k[0].hash64(k[1], msg.contiguous()) if k else hashes.hash64(msg)


def hash64_plain(hashes, msg: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hash64`, on any device."""
    k = _kernels(hashes, "cpu")
    return (k[0].hash64_plain(k[1], msg.contiguous()) if k
            else hashes.hash64(msg))


def prove(hashes, pi_tildes: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """The reference's flat fold of pi_tildes [N, 4, 4] from cs [4, 4]:
    the hash's chain kernel on the card."""
    k = _kernels(hashes, pi_tildes.device)
    pts, cs = pi_tildes.contiguous(), cs.contiguous()
    return k[0].chain(k[1], pts, cs) if k else _vdpf.prove(hashes.hash64,
                                                           pts, cs)


def prove_plain(hashes, pi_tildes: torch.Tensor,
                cs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`prove`, on any device."""
    k = _kernels(hashes, "cpu")
    pts, cs = pi_tildes.contiguous(), cs.contiguous()
    return k[0].chain_plain(k[1], pts, cs) if k else _vdpf.prove(
        hashes.hash64, pts, cs)


def fold(hashes, pi_tildes, cs, how: str = "reference") -> torch.Tensor:
    """The proof by fold ``how``, every H' through the hash's kernels."""
    return _vdpf.fold(lambda m: hash64(hashes, m), pi_tildes, cs, how,
                      lambda _, p, c: prove(hashes, p, c))


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def _check_eval(s0, cws, xs, in_bits, party):
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    if not 1 <= in_bits <= 128:
        raise ValueError(f"in_bits must be in 1..128, got {in_bits}")
    B = xs.shape[0]
    dev = _device(s0, cws, xs)
    _build.check(s0, "s0", dev, [(B, 4), (4,)])
    _build.check(cws, "cws", dev, [(B, in_bits, 8), (in_bits, 8)])
    _build.check(xs, "xs", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    return dev


def eval_packed(s0: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor,
                in_bits: int, party: int, prg, hashes):
    """The DPF walk with ``prg`` (ChaCha or AesMmo, mul=2) and the XorHash
    of (x, leaf seed) for a batch of keys.

    s0: [B, 4] seeds or one [4] seed; cws: VDPF wire rows [B, in_bits, 8]
    or one key [in_bits, 8]; xs: [B], or [B, 4] lanes (required for
    in_bits > 32). All int32. Returns (so [B, 4] leaf seeds with the
    clamped bit clear, t [B], pi [B, 4, 4] = H(x lanes, so) before the
    cs correction).
    """
    dev = _check_eval(s0, cws, xs, in_bits, party)
    kind = hash_kind(hashes, dev)
    arg, tag = _build.prg_arg(prg, 2)
    if dev.type == "cpu":
        return eval_packed_plain(s0, cws, xs, in_bits, party, prg, hashes)
    B = xs.shape[0]
    so = torch.empty((B, 4), dtype=torch.int32, device=dev)
    t = torch.empty((B,), dtype=torch.int32, device=dev)
    pi = torch.empty((B, 4, 4), dtype=torch.int32, device=dev)
    fn = _build.function("vdpf_eval", "fss_vdpf_eval", _EVAL_ARGS)
    _build.launch(
        "vdpf_eval", fn, s0.data_ptr(), 4 if s0.dim() == 2 else 0,
        cws.data_ptr(), in_bits * 8 if cws.dim() == 3 else 0, xs.data_ptr(),
        4 if xs.dim() == 2 else 1, so.data_ptr(), t.data_ptr(),
        pi.data_ptr(), B, in_bits, int(party), kind, *_hash_args(hashes),
        arg, device=dev, kernel="vdpf_eval" + tag)
    return so, t, pi


def eval_packed_plain(s0, cws, xs, in_bits: int, party: int, prg, hashes):
    """Plain PyTorch version of :func:`eval_packed`, on any device: the
    DPF's plain walk and the hash's plain version."""
    _check_eval(s0, cws, xs, in_bits, party)
    _build.check_prg(prg, 2)
    B = xs.shape[0]
    wide = cws.expand(B, in_bits, 8)
    x = _x_lanes(xs)
    so, t = _dpf.walk(prg, in_bits, party, s0.expand(B, 4),
                      lambda i: wide[:, i],
                      blk.input_bits_msb_first(x, in_bits))
    return so, t, xor_hash_plain(hashes, x, so)


def eval_points(prg, hashes, group, in_bits: int, party: int, s0, cws, cs,
                ocw, xs):
    """Point evaluation: the kernel's walk and hash, then the correction
    and the DPF's group finalize. Returns (ys [B, 4], pi_tildes
    [B, 4, 4])."""
    so, t, pi = eval_packed(s0, cws, xs, in_bits, party, prg, hashes)
    ys = _dpf.finalize_leaves(group, party, so, t, ocw)
    return ys, _vdpf.correct_(pi, t, cs)


# ---------------------------------------------------------------------------
# Gen
# ---------------------------------------------------------------------------

def gen_batch(prg, hashes, group, in_bits: int, s0s, alphas, betas):
    """Batched Gen: the DPF Gen kernel's levels into VDPF wire rows, then
    cs through the XorHash kernel, the fail mask and the output CW.

    s0s [B, 2, 4]; alphas [B], or [B, 4] lanes (required for
    in_bits > 32); betas [B, 4]. Returns (cws [B, in_bits, 8], cs
    [B, 4, 4], ocw [B, 4], fail [B]).
    """
    cws, s0f, s1f, t0, t1 = dpf_cuda.gen_packed(s0s, alphas, in_bits, prg,
                                                "wire", ocw_row=False)
    return (cws, *_vdpf.finish_gen(
        lambda a, b: xor_hash(hashes, a, b), group,
        _x_lanes(alphas).contiguous(), s0f, s1f, t0, t1, betas))
