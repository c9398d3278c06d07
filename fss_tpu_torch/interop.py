"""Carry state between the JAX package and the port.

The JAX package's state is numpy uint32 arrays (``np.asarray`` of its
jax arrays); the port's is int32 tensors with the same bits. This module
converts seeds [..., 2, 4], wire keys [B, in_bits+1, 8], the JAX
package's packed keys (cw planes [in_bits, 5, T, 128] + ocw [B, 4]) and
DPF, DCF, Half-Tree and VDPF configurations described by plain values, in
both directions, with the ChaCha PRG (``nonce``, ``rounds``) or AES-128-MMO
(``aes_keys``, hex). A JAX ``Aes128Mmo`` crosses with its ``backend`` and
``unroll`` left behind: every backend computes the same bits. Half-Tree keys (cws [B, in_bits, 8], ocw [B, 4]) cross as two
arrays through :func:`to_torch` and :func:`to_numpy`, and VDPF keys (cws
[B, in_bits, 8], cs [B, 4, 4], ocw [B, 4]) as three. Hash keys and IVs
cross as plain ints. Grotto DCF and VDMPF configurations cross the same
way; a VDMPF key crosses as its sigma bytes, m_rt and b_size_rt as ints
and its four arrays, a Grotto ``ParityTree`` as its levels and a
``PrefixTable`` as its words, each with its party. It
imports nothing of the JAX package: a caller hands it arrays and values,
or objects with the same field names as the JAX package's (read by
attribute), and gets back tuples in those objects' field order.
"""

from __future__ import annotations

import numpy as np
import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import (Dcf, Dpf, GrottoDcf, HalfTreeDpf,
                               PackedDpfKeys, Vdmpf, Vdpf)
from fss_tpu_torch.hash import Blake3, Sha256
from fss_tpu_torch.ops.ht_cuda import hash_words
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes.grotto_dcf import ParityTree, PrefixTable
from fss_tpu_torch.schemes.vdmpf import VdmpfKey

LANES = 128  # key lanes per row of the JAX package's packed planes


def to_torch(arr, device="cuda") -> torch.Tensor:
    """uint32 array (seeds, keys, shares, xs) -> int32 tensor, same bits."""
    return blk.words(np.asarray(arr), device).contiguous()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array, same bits."""
    return blk.to_numpy(t)


def packed_keys_from_jax(cws_t, ocw, device="cuda") -> PackedDpfKeys:
    """JAX packed keys (cws_t [n, 5, T, 128], ocw [B, 4]) -> the port's
    PackedDpfKeys (planes [n, 5, B], ocw [B, 4])."""
    cws_t = np.asarray(cws_t)
    n, words, T, lanes = cws_t.shape
    B = np.asarray(ocw).shape[0]
    planes = cws_t.reshape(n, words, T * lanes)[:, :, :B]
    return PackedDpfKeys(to_torch(planes, device), to_torch(ocw, device))


def packed_keys_to_jax(keys: PackedDpfKeys):
    """The port's PackedDpfKeys -> (cws_t [n, 5, T, 128], ocw [B, 4])
    uint32 arrays, padded with zero keys to whole 128-key rows."""
    planes = to_numpy(keys.cws_p)
    n, words, B = planes.shape
    T = -(-B // LANES)
    padded = np.zeros((n, words, T * LANES), dtype=np.uint32)
    padded[:, :, :B] = planes
    return padded.reshape(n, words, T, LANES), to_numpy(keys.ocw)


def dpf_config(in_bits: int, group, prg) -> dict:
    """A DPF configuration as plain values, read from a group and a PRG
    of either package (Bytes has ``name == "bytes"``, Uint has ``bits`` and
    ``mod``; a ChaCha PRG has ``nonce`` and ``rounds``, an AES-MMO PRG
    ``keys``, 16 bytes each)."""
    cfg = {"in_bits": int(in_bits), "group": group.name}
    if hasattr(prg, "keys"):
        cfg.update(prg="aes", aes_keys=[bytes(k).hex() for k in prg.keys])
    else:
        cfg.update(nonce=[int(n) for n in prg.nonce], rounds=int(prg.rounds))
    if group.name != "bytes":
        cfg.update(group="uint", bits=int(group.bits), mod=int(group.mod))
    return cfg


def _scheme_args(cfg: dict, mul: int) -> dict:
    group = (groups.Bytes() if cfg["group"] == "bytes"
             else groups.Uint(cfg["bits"], cfg.get("mod", 0)))
    if cfg.get("prg") == "aes":
        prg = AesMmo(mul, [bytes.fromhex(k) for k in cfg["aes_keys"][:mul]])
    else:
        prg = ChaCha(mul=mul, nonce=tuple(cfg["nonce"]),
                     rounds=cfg.get("rounds", 20))
    return {"group": group, "prg": prg}


def dpf_from_config(cfg: dict, device="cuda") -> Dpf:
    """The port's Dpf for a configuration made by :func:`dpf_config`."""
    return Dpf(cfg["in_bits"], device=device, **_scheme_args(cfg, 2))


def dcf_config(in_bits: int, group, prg, pred: str = "lt") -> dict:
    """A DCF configuration as plain values: :func:`dpf_config`'s fields
    and the predicate."""
    return {**dpf_config(in_bits, group, prg), "pred": pred}


def dcf_from_config(cfg: dict, device="cuda") -> Dcf:
    """The port's Dcf for a configuration made by :func:`dcf_config`."""
    return Dcf(cfg["in_bits"], pred=cfg.get("pred", "lt"), device=device,
               **_scheme_args(cfg, 4))


def half_tree_config(in_bits: int, group, prg, hash_key) -> dict:
    """A Half-Tree DPF configuration as plain values: :func:`dpf_config`'s
    fields and the CCR hash key (4 words, an array of either package)."""
    return {**dpf_config(in_bits, group, prg),
            "hash_key": list(hash_words(hash_key))}


def half_tree_from_config(cfg: dict, device="cuda") -> HalfTreeDpf:
    """The port's HalfTreeDpf for a configuration made by
    :func:`half_tree_config`."""
    return HalfTreeDpf(cfg["in_bits"], hash_key=cfg["hash_key"],
                       device=device, **_scheme_args(cfg, 1))


def vdpf_config(in_bits: int, group, prg, hashes) -> dict:
    """A VDPF configuration as plain values: :func:`dpf_config`'s fields
    and the hash, read from a Blake3 (``iv``, 8 words) or Sha256 (``key``,
    4 words) of either package."""
    cfg = dpf_config(in_bits, group, prg)
    if hasattr(hashes, "iv"):
        return {**cfg, "hash": "blake3",
                "hash_iv": list(blk.key_words(hashes.iv, 8, "iv"))}
    if hasattr(hashes, "key"):
        return {**cfg, "hash": "sha256",
                "hash_key": list(blk.key_words(hashes.key, 4, "key"))}
    raise TypeError(f"no BLAKE3 iv or SHA-256 key on {type(hashes).__name__}")




def _hashes(cfg: dict):
    return (Blake3(cfg["hash_iv"]) if cfg["hash"] == "blake3"
            else Sha256(cfg["hash_key"]))


def vdpf_from_config(cfg: dict, device="cuda") -> Vdpf:
    """The port's Vdpf for a configuration made by :func:`vdpf_config`."""
    return Vdpf(cfg["in_bits"], hashes=_hashes(cfg), device=device,
                **_scheme_args(cfg, 2))


def grotto_config(in_bits: int, prg) -> dict:
    """A Grotto DCF configuration as plain values: the domain and the PRG
    (its group is always ``Bytes``)."""
    return dpf_config(in_bits, groups.Bytes(), prg)


def grotto_from_config(cfg: dict, device="cuda") -> GrottoDcf:
    """The port's GrottoDcf for a configuration made by
    :func:`grotto_config`."""
    return GrottoDcf(cfg["in_bits"], prg=_scheme_args(cfg, 2)["prg"],
                     device=device)


def vdmpf_config(in_bits: int, group, prg, hashes, max_points: int,
                 bucket_bits: int, kappa: int = 3,
                 ch_lambda: int = 80) -> dict:
    """A VDMPF configuration as plain values: :func:`vdpf_config`'s fields
    and the bucket array's parameters."""
    return {**vdpf_config(in_bits, group, prg, hashes),
            "max_points": int(max_points), "bucket_bits": int(bucket_bits),
            "kappa": int(kappa), "ch_lambda": int(ch_lambda)}


def vdmpf_from_config(cfg: dict, device="cuda") -> Vdmpf:
    """The port's Vdmpf for a configuration made by :func:`vdmpf_config`."""
    return Vdmpf(cfg["in_bits"], max_points=cfg["max_points"],
                 bucket_bits=cfg["bucket_bits"], hashes=_hashes(cfg),
                 kappa=cfg["kappa"], ch_lambda=cfg["ch_lambda"],
                 device=device, **_scheme_args(cfg, 2))


def vdmpf_key_from_jax(key, device="cuda") -> VdmpfKey:
    """A JAX package's VdmpfKey -> the port's: sigma's bytes, m_rt and
    b_size_rt as ints, and the four arrays as int32 tensors."""
    return VdmpfKey(bytes(key.sigma), int(key.m_rt), int(key.b_size_rt),
                    *(to_torch(getattr(key, f), device)
                      for f in ("s0", "cws", "cs", "ocw")))


def vdmpf_key_to_jax(key: VdmpfKey) -> tuple:
    """The port's VdmpfKey -> (sigma, m_rt, b_size_rt, s0, cws, cs, ocw),
    the JAX package's VdmpfKey fields, the arrays as uint32."""
    return (bytes(key.sigma), int(key.m_rt), int(key.b_size_rt),
            *(to_numpy(t) for t in (key.s0, key.cws, key.cs, key.ocw)))


def parity_tree_from_jax(pt, device="cuda") -> ParityTree:
    """A JAX package's ParityTree (uint32 0/1 levels) -> the port's."""
    return ParityTree(tuple(to_torch(level, device) for level in pt.levels),
                      int(pt.party))


def parity_tree_to_jax(pt: ParityTree) -> tuple:
    """The port's ParityTree -> (levels as uint32 arrays, party)."""
    return tuple(to_numpy(level) for level in pt.levels), int(pt.party)


def prefix_table_from_jax(table, device="cuda") -> PrefixTable:
    """A JAX package's PrefixTable (uint32 words) -> the port's."""
    return PrefixTable(to_torch(table.words, device), int(table.party),
                       int(table.in_bits))


def prefix_table_to_jax(table: PrefixTable) -> tuple:
    """The port's PrefixTable -> (words as uint32, party, in_bits)."""
    return to_numpy(table.words), int(table.party), int(table.in_bits)
