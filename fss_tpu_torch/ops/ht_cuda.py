"""Batched Half-Tree DPF point evaluation and Gen on the card: wrappers of
the CUDA kernels ``csrc/ht_eval.cu`` and ``csrc/ht_gen.cu``.

Counterpart of ``fss_tpu.ops.ht_pallas`` and of
``fss_tpu.ops.aes_pallas.ht_eval_packed``. The kernels replace
``ht_pallas.eval_packed`` and ``ht_pallas.gen_packed`` with the ChaCha
PRG, and ``aes_pallas.ht_eval_packed`` with AES-128-MMO (the JAX package
has no AES Half-Tree Gen kernel; here it is the AES instantiation of the
Gen kernel): each wrapper takes the PRG object (``prg``, ChaCha or AesMmo
with mul=1). Each source file says what bounds it on the H100 and what
its design does about that: with AES the Eval kernel reads each level's
key row in one 16-byte load (``csrc/ht_eval.cu``), so the wrapper hands
it a 16-byte aligned ``cws`` (an aligned copy where the given one is
not).

Dispatch is by the tensors' device only: CUDA tensors go to the kernel
(a failing build or launch raises), CPU tensors to the plain PyTorch
version beside each wrapper (``*_plain``), which computes the same
function and is what the CPU tests and the card's kernel checks compare
with. The Gen kernel ends with the group-typed output CW when it is given
betas and the group (``csrc/group.cuh``), so ``gen_batch`` is one launch;
the Eval finalize (the DPF's ``finalize_leaves``) is elementwise glue
outside the kernel, as in the JAX package.

The CCR hash key and the PRG's nonce or round keys reach the kernels as
arguments (the TPU kernels bake them in as constants), so a new key needs
no rebuild. Keys are wire rows [B, in_bits, 8], which the Eval kernel reads
in place through strides, or one broadcast key [in_bits, 8]; the output
CW is [B, 4] or one [4]. Both kernels take every ``in_bits`` in 1..128,
with x and alpha as 1 lane (in_bits <= 32) or 4.
"""

from __future__ import annotations

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.ops.dpf_cuda import _device, _x_lanes
from fss_tpu_torch.schemes import dpf as _dpf
from fss_tpu_torch.schemes import half_tree_dpf as _ht

_EVAL_ARGS = (_build.P, _build.I64, _build.P, _build.I64, _build.P,
              _build.I64, _build.P, _build.P, _build.I64, _build.INT,
              _build.INT, *(_build.U32,) * 4, _build.P, _build.P)
_GEN_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P, _build.P,
             _build.P, _build.P, _build.I64, _build.INT, *(_build.U32,) * 4,
             _build.INT, *(_build.U32,) * 8, _build.P, _build.P)


def hash_words(hash_key) -> tuple:
    """A CCR hash key given as 4 words (a sequence, an array or a tensor)
    -> 4 ints in [0, 2^32)."""
    if isinstance(hash_key, torch.Tensor):
        hash_key = hash_key.detach().cpu().tolist()
    words = tuple(int(w) & blk.MASK32 for w in np.asarray(hash_key).ravel())
    if len(words) != 4:
        raise ValueError(f"hash_key must be 4 words, got {len(words)}")
    return words


def hash_block(hash_key, device) -> torch.Tensor:
    """The hash key as a [4] int32 block on ``device``."""
    return blk.words(list(hash_words(hash_key)), device)


def _check_in_bits(in_bits: int) -> None:
    if not 1 <= in_bits <= 128:
        raise ValueError(f"in_bits must be in 1..128, got {in_bits}")


def _check_eval(s0, cws, xs, in_bits, party):
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    _check_in_bits(in_bits)
    B = xs.shape[0]
    dev = _device(s0, cws, xs)
    _build.check(s0, "s0", dev, [(B, 4), (4,)])
    _build.check(cws, "cws", dev, [(B, in_bits, 8), (in_bits, 8)])
    _build.check(xs, "xs", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    return dev


def eval_packed(s0: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor,
                in_bits: int, party: int, prg, hash_key):
    """The Half-Tree walk and last-level conversion for a batch of keys,
    with ``prg`` (ChaCha or AesMmo, mul=1) as the CCR hash.

    s0: [B, 4] seeds or one [4] seed; cws: wire rows [B, in_bits, 8] or
    one key [in_bits, 8]; xs: [B], or [B, 4] lanes (required for
    in_bits > 32). All int32. Returns (high [B, 4] with the clamped bit
    clear, low [B]): the corrected leaf, before the group finalize.
    """
    dev = _check_eval(s0, cws, xs, in_bits, party)
    arg, tag = _build.prg_arg(prg, 1)
    if dev.type == "cpu":
        return eval_packed_plain(s0, cws, xs, in_bits, party, prg, hash_key)
    B = xs.shape[0]
    if cws.data_ptr() % 16:  # the kernel's 16-byte row loads
        cws = cws.clone()
    high = torch.empty((B, 4), dtype=torch.int32, device=dev)
    low = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.function("ht_eval", "fss_ht_eval", _EVAL_ARGS)
    _build.launch(
        "ht_eval", fn, s0.data_ptr(), 4 if s0.dim() == 2 else 0,
        cws.data_ptr(), in_bits * 8 if cws.dim() == 3 else 0, xs.data_ptr(),
        4 if xs.dim() == 2 else 1, high.data_ptr(), low.data_ptr(), B,
        in_bits, int(party), *hash_words(hash_key), arg, device=dev,
        kernel="ht_eval" + tag)
    return high, low


def eval_packed_plain(s0, cws, xs, in_bits: int, party: int, prg,
                      hash_key):
    """Plain PyTorch version of :func:`eval_packed` (same inputs, same
    outputs), on any device."""
    _check_eval(s0, cws, xs, in_bits, party)
    _build.check_prg(prg, 1)
    B = xs.shape[0]
    wide = cws.expand(B, in_bits, 8)
    x_bits = blk.input_bits_msb_first(_x_lanes(xs), in_bits)
    hk = hash_block(hash_key, xs.device)
    node = _ht.walk(prg, in_bits, party, hk, s0.expand(B, 4),
                    lambda i: wide[:, i, 0:4], x_bits)
    return _ht.convert_at(prg, hk, node, x_bits[:, in_bits - 1],
                          wide[:, in_bits - 1])


def eval_points(prg, group, in_bits: int, party: int, hash_key, s0, cws,
                ocw, xs) -> torch.Tensor:
    """Point evaluation: kernel walk + the DPF's group finalize."""
    high, low = eval_packed(s0, cws, xs, in_bits, party, prg, hash_key)
    return _dpf.finalize_leaves(group, party, high, low, ocw)


# ---------------------------------------------------------------------------
# Gen
# ---------------------------------------------------------------------------

def _check_gen(s0s, alphas, in_bits, betas, group):
    _check_in_bits(in_bits)
    if (betas is None) != (group is None):
        raise ValueError("the output CW needs both betas and the group")
    B = s0s.shape[0]
    dev = _device(s0s, alphas, *(() if betas is None else (betas,)))
    _build.check(s0s, "s0s", dev, [(B, 2, 4)])
    _build.check(alphas, "alphas", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    if betas is not None:
        _build.check(betas, "betas", dev, [(B, 4)])
    return dev


def gen_packed(s0s: torch.Tensor, alphas: torch.Tensor, in_bits: int, prg,
               hash_key, betas=None, group=None):
    """Every level of Half-Tree Gen for a batch of keys, with ``prg``
    (ChaCha or AesMmo, mul=1) as the CCR hash, and the output CW given
    ``betas`` and ``group``.

    s0s [B, 2, 4] seeds; alphas [B], or [B, 4] lanes (required for
    in_bits > 32); betas [B, 4] or None. Returns (cws [B, in_bits, 8]
    whole wire rows, ocw [B, 4]) with betas, else (cws, leaf0 [B, 4],
    leaf1 [B, 4]): the parties' corrected leaves in the alpha direction,
    from which the output CW is made.
    """
    dev = _check_gen(s0s, alphas, in_bits, betas, group)
    arg, tag = _build.prg_arg(prg, 1)
    if dev.type == "cpu":
        return gen_packed_plain(s0s, alphas, in_bits, prg, hash_key, betas,
                                group)
    B = s0s.shape[0]
    cws = torch.empty((B, in_bits, 8), dtype=torch.int32, device=dev)
    def out():
        return torch.empty((B, 4), dtype=torch.int32, device=dev)
    leaf0, leaf1, ocw = ((out(), out(), None) if betas is None else
                         (None, None, out()))
    mode = groups.group_mode(group) if group is not None else "xor"
    mask, mod = groups.gen_params(group) if group is not None else \
        ((0,) * 4, (0,) * 4)
    fn = _build.function("ht_gen", "fss_ht_gen", _GEN_ARGS)
    _build.launch(
        "ht_gen", fn, s0s.data_ptr(), alphas.data_ptr(),
        4 if alphas.dim() == 2 else 1,
        *(None if t is None else t.data_ptr()
          for t in (betas, cws, leaf0, leaf1, ocw)),
        B, in_bits, *hash_words(hash_key), groups.MODES.index(mode), *mask,
        *mod, arg, device=dev, kernel="ht_gen" + tag)
    return (cws, leaf0, leaf1) if betas is None else (cws, ocw)


def gen_packed_plain(s0s, alphas, in_bits: int, prg, hash_key, betas=None,
                     group=None):
    """Plain PyTorch version of :func:`gen_packed`, on any device."""
    _check_gen(s0s, alphas, in_bits, betas, group)
    _build.check_prg(prg, 1)
    cws, leaf0, leaf1 = _ht.gen_keys(
        prg, in_bits, hash_block(hash_key, s0s.device), s0s,
        blk.input_bits_msb_first(_x_lanes(alphas), in_bits))
    if betas is None:
        return cws, leaf0, leaf1
    return cws, _ht.output_cw(group, leaf0, leaf1, betas)


def gen_batch(prg, group, in_bits: int, hash_key, s0s, alphas, betas):
    """Batched Gen: (cws [B, in_bits, 8], ocw [B, 4]), one launch."""
    return gen_packed(s0s, alphas, in_bits, prg, hash_key, betas=betas,
                      group=group)
