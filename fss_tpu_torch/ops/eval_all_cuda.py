"""DPF full-domain evaluation (EvalAll) on the card: wrapper of the CUDA
kernel ``csrc/dpf_eval_all.cu``.

Counterpart of the DPF part of ``fss_tpu.ops.eval_all_pallas``; the
kernel replaces ``eval_all_pallas._expand_packed``. Nodes are packed
(s, t) [N, 4] int32 blocks with t in the clamped bit.

Split: every level runs through the kernel, the root's first, in launches
of up to ``LEVELS_PER_LAUNCH`` levels (the remainder first, so the last
launches expand full strides). There is no host-side prefix and no
domain-size threshold: a prefix of int64 ChaCha in torch glue would cost
hundreds of tiny launches per level, and one kernel launch per level
stride costs a few microseconds at any width. The last launch writes the
seeds with the clamped bit cleared and the t bits as their own plane.

CUDA tensors go to the kernel (a failing build or launch raises), CPU
tensors to the plain PyTorch version :func:`expand_packed_plain`.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dpf as _dpf

LEVELS_PER_LAUNCH = 3

_EXPAND_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P,
                _build.I64, _build.INT, _build.U32, _build.U32, _build.INT,
                _build.P)


def _check(roots, cw_rows):
    dev = roots.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _build.check(roots, "roots", dev, [(roots.shape[0], 4)])
    if cw_rows.dim() != 2 or cw_rows.shape[1] < 5:
        raise ValueError(f"cw_rows must be [L, >=5], got "
                         f"{tuple(cw_rows.shape)}")
    if cw_rows.device != dev or cw_rows.dtype != torch.int32:
        raise ValueError("cw_rows must be int32 on the roots' device")
    if cw_rows.stride(1) != 1:
        raise ValueError("cw_rows words must be contiguous")
    if not 1 <= cw_rows.shape[0] <= LEVELS_PER_LAUNCH:
        raise ValueError(f"1..{LEVELS_PER_LAUNCH} levels per launch, got "
                         f"{cw_rows.shape[0]}")
    return dev


def expand_packed(roots: torch.Tensor, cw_rows: torch.Tensor, nonce,
                  rounds: int = 20, final: bool = False):
    """Expand packed nodes [N, 4] by L = cw_rows.shape[0] levels (1..3).

    cw_rows: [L, 8] (or [L, >=5]) int32 cw rows of those levels. Returns
    the packed children [N << L, 4] in x order, or with ``final`` the
    pair (seeds [N << L, 4] with the clamped bit clear, t [N << L]).
    """
    dev = _check(roots, cw_rows)
    if dev.type == "cpu":
        return expand_packed_plain(roots, cw_rows, nonce, rounds, final)
    L = cw_rows.shape[0]
    n = roots.shape[0] << L
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.int32, device=dev) if final else None
    prg = ChaCha(2, nonce, rounds)  # validates rounds, masks the nonce
    fn = _build.function("dpf_eval_all", "fss_dpf_expand", _EXPAND_ARGS)
    _build.launch(
        "dpf_eval_all", fn, roots.data_ptr(), cw_rows.data_ptr(),
        cw_rows.stride(0), out.data_ptr(),
        t.data_ptr() if final else None, roots.shape[0], L, *prg.nonce,
        prg.rounds, device=dev)
    return (out, t) if final else out


def expand_packed_plain(roots, cw_rows, nonce, rounds: int = 20,
                        final: bool = False):
    """Plain PyTorch version of :func:`expand_packed`, on any device."""
    _check(roots, cw_rows)
    prg2 = ChaCha(2, nonce, rounds)
    s, t = _tree.split_seed(roots)
    for row in cw_rows:
        s, t = _tree.expand_level(prg2, s, t, *_tree.unpack_cw_row(row))
    return (s, t) if final else blk.set_lsb(s, t)


def expand_leaves(prg2, in_bits: int, party: int, s0: torch.Tensor,
                  cws: torch.Tensor, expand=expand_packed):
    """Expand one key to its leaf layer: (seeds [2^n, 4], t [2^n]) in x
    order. ``expand`` is the per-launch step (the plain version can be
    passed to time the same sequence without the kernel)."""
    if in_bits < 1:
        raise ValueError(f"EvalAll needs in_bits >= 1, got {in_bits}")
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    nodes = blk.set_lsb(blk.clear_lsb(s0), party)[None, :].contiguous()
    lvl = 0
    step = in_bits % LEVELS_PER_LAUNCH or LEVELS_PER_LAUNCH
    while lvl < in_bits:
        nodes = expand(nodes, cws[lvl:lvl + step], prg2.nonce, prg2.rounds,
                       final=lvl + step == in_bits)
        lvl += step
        step = LEVELS_PER_LAUNCH
    return nodes


def eval_all(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor) -> torch.Tensor:
    """Full-domain DPF evaluation of one key: [2^in_bits, 4] shares in
    x order. ``prg2`` is the ChaCha mul=2 PRG whose nonce and rounds
    drive the kernel."""
    s, t = expand_leaves(prg2, in_bits, party, s0, cws)
    return _dpf.finalize_leaves(group, party, s, t, cws[in_bits, 0:4])
