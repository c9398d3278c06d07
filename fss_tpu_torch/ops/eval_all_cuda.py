"""DPF, DCF, Half-Tree and VDPF full-domain evaluation (EvalAll) on the
card: wrappers of the CUDA kernels ``csrc/dpf_eval_all.cu``,
``csrc/dcf_eval_all.cu`` and ``csrc/ht_eval_all.cu``; the VDPF expands its
tree with the DPF's kernel and hashes and folds with the hash kernels.

Counterpart of ``fss_tpu.ops.eval_all_pallas``; the kernels replace
``eval_all_pallas._expand_packed``, ``eval_all_pallas.dcf_eval_all`` and
``eval_all_pallas.ht_eval_all`` with the ChaCha PRG, and with AES-128-MMO
they are the card's AES EvalAll, which the JAX package runs as XLA. Each
wrapper takes the scheme's PRG object (ChaCha or AesMmo). Nodes are packed
(s, t) [N, 4] int32 blocks with t in the clamped bit; a DCF node also carries its raw value
accumulator [N, 4 or 5] (``ops/dcf_cuda.py``); a Half-Tree node is the
whole 128-bit node, which holds t in the same bit.

Split: every level runs through the kernel, the root's first, in launches
of up to :func:`levels_per_launch` levels (the remainder first, so the
last launches expand full strides): 3 with ChaCha, 1 with AES, whose
unrolled blocks at 2-3 levels a launch take ptxas minutes a kernel and
whose levels are bound by their table lookups, not by the nodes' round
trip through memory. There is no host-side prefix and no
domain-size threshold: a prefix of the plain PRG in torch glue would cost
hundreds of tiny launches per level, and one kernel launch per level
stride costs a few microseconds at any width. The last launch writes the
seeds with the clamped bit cleared and the t bits as their own plane.

The Half-Tree counts its conversion level as one of its in_bits levels:
the n-1 doubling levels and the conversion split into launches the same
way, and the last launch ends with the conversion, which writes 2 leaves
a node, (high, low), in x order.

CUDA tensors go to the kernel (a failing build or launch raises), CPU
tensors to the plain PyTorch versions :func:`expand_packed_plain`,
:func:`dcf_expand_packed_plain` and :func:`ht_expand_packed_plain`.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.block import i32, u64
from fss_tpu_torch.ops import dcf_cuda, ht_cuda, vdpf_cuda
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dcf as _dcf
from fss_tpu_torch.schemes import dpf as _dpf
from fss_tpu_torch.schemes import half_tree_dpf as _ht
from fss_tpu_torch.schemes import vdpf as _vdpf

LEVELS_PER_LAUNCH = 3
AES_LEVELS_PER_LAUNCH = 1  # fss::kMaxLevels of csrc/prg.cuh

_EXPAND_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P,
                _build.I64, _build.INT, _build.P, _build.P)
_DCF_EXPAND_ARGS = (_build.P, _build.P, _build.P, _build.I64, _build.P,
                    _build.P, _build.P, _build.I64, _build.INT, _build.INT,
                    *(_build.U32,) * 4, _build.P, _build.P)
_HT_EXPAND_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P,
                   _build.I64, _build.INT, _build.INT, *(_build.U32,) * 4,
                   _build.P, _build.P)


def levels_per_launch(prg) -> int:
    """The most levels one EvalAll launch expands with ``prg``."""
    return AES_LEVELS_PER_LAUNCH if isinstance(prg, AesMmo) \
        else LEVELS_PER_LAUNCH


def _check(roots, cw_rows, prg, row_words=5):
    dev = roots.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _build.check(roots, "roots", dev, [(roots.shape[0], 4)])
    if cw_rows.dim() != 2 or cw_rows.shape[1] < row_words:
        raise ValueError(f"cw_rows must be [L, >={row_words}], got "
                         f"{tuple(cw_rows.shape)}")
    if cw_rows.device != dev or cw_rows.dtype != torch.int32:
        raise ValueError("cw_rows must be int32 on the roots' device")
    if cw_rows.stride(1) != 1:
        raise ValueError("cw_rows words must be contiguous")
    most = levels_per_launch(prg)
    if not 1 <= cw_rows.shape[0] <= most:
        raise ValueError(f"1..{most} levels per launch, got "
                         f"{cw_rows.shape[0]}")
    return dev


def _launch_levels(in_bits: int, party: int, prg):
    """The level ranges (start, stop) of each launch: the remainder first,
    then strides of levels_per_launch(prg)."""
    if in_bits < 1:
        raise ValueError(f"EvalAll needs in_bits >= 1, got {in_bits}")
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    step = levels_per_launch(prg)
    first = in_bits % step or step
    return [(0, first)] + [(lvl, lvl + step) for lvl in
                           range(first, in_bits, step)]


# ---------------------------------------------------------------------------
# DPF
# ---------------------------------------------------------------------------

def expand_packed(roots: torch.Tensor, cw_rows: torch.Tensor, prg,
                  final: bool = False):
    """Expand packed nodes [N, 4] by L = cw_rows.shape[0] levels (1..3)
    with ``prg`` (ChaCha or AesMmo, mul=2).

    cw_rows: [L, 8] (or [L, >=5]) int32 cw rows of those levels. Returns
    the packed children [N << L, 4] in x order, or with ``final`` the
    pair (seeds [N << L, 4] with the clamped bit clear, t [N << L]).
    """
    dev = _check(roots, cw_rows, prg)
    arg, tag = _build.prg_arg(prg, 2)
    if dev.type == "cpu":
        return expand_packed_plain(roots, cw_rows, prg, final)
    L = cw_rows.shape[0]
    n = roots.shape[0] << L
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.int32, device=dev) if final else None
    fn = _build.function("dpf_eval_all", "fss_dpf_expand", _EXPAND_ARGS)
    _build.launch(
        "dpf_eval_all", fn, roots.data_ptr(), cw_rows.data_ptr(),
        cw_rows.stride(0), out.data_ptr(),
        t.data_ptr() if final else None, roots.shape[0], L, arg,
        device=dev, kernel="dpf_eval_all" + tag)
    return (out, t) if final else out


def expand_packed_plain(roots, cw_rows, prg, final: bool = False):
    """Plain PyTorch version of :func:`expand_packed`, on any device."""
    _check(roots, cw_rows, prg)
    _build.check_prg(prg, 2)
    s, t = _tree.split_seed(roots)
    for row in cw_rows:
        s, t = _tree.expand_level(prg, s, t, *_tree.unpack_cw_row(row))
    return (s, t) if final else blk.set_lsb(s, t)


def expand_leaves(prg2, in_bits: int, party: int, s0: torch.Tensor,
                  cws: torch.Tensor, expand=expand_packed):
    """Expand one key to its leaf layer: (seeds [2^n, 4], t [2^n]) in x
    order. ``expand`` is the per-launch step (the plain version can be
    passed to time the same sequence without the kernel)."""
    nodes = blk.set_lsb(blk.clear_lsb(s0), party)[None, :].contiguous()
    for lo, hi in _launch_levels(in_bits, party, prg2):
        nodes = expand(nodes, cws[lo:hi], prg2, final=hi == in_bits)
    return nodes


def eval_all(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor) -> torch.Tensor:
    """Full-domain DPF evaluation of one key: [2^in_bits, 4] shares in
    x order. ``prg2`` is the scheme's mul=2 PRG (ChaCha or AesMmo)."""
    s, t = expand_leaves(prg2, in_bits, party, s0, cws)
    return _dpf.finalize_leaves(group, party, s, t, cws[in_bits, 0:4])


# ---------------------------------------------------------------------------
# DCF
# ---------------------------------------------------------------------------

def _check_dcf(roots, acc, cw_rows, prg, group_mode):
    dev = _check(roots, cw_rows, prg, row_words=8)
    if group_mode not in dcf_cuda.MODES:
        raise ValueError(f"group_mode must be one of {dcf_cuda.MODES}, got "
                         f"{group_mode!r}")
    _build.check(acc, "acc", dev,
                 [(roots.shape[0], dcf_cuda.acc_words(group_mode))])
    return dev


def dcf_expand_packed(roots: torch.Tensor, acc: torch.Tensor,
                      cw_rows: torch.Tensor, prg, group_mode: str = "wrap",
                      vmask=dcf_cuda.FULL, final: bool = False):
    """Expand DCF nodes by L = cw_rows.shape[0] levels (1..3) with ``prg``
    (ChaCha or AesMmo, mul=4).

    roots [N, 4] packed (s, t); acc [N, 4 or 5] their raw accumulators;
    cw_rows [L, 8] int32 cw rows of those levels; ``group_mode`` and
    ``vmask`` as for ``dcf_cuda.eval_packed``. Returns (children
    [N << L, 4] packed, acc [N << L, 4 or 5]) in x order, or with ``final``
    (seeds [N << L, 4] with the clamped bit clear, t [N << L], acc).
    """
    dev = _check_dcf(roots, acc, cw_rows, prg, group_mode)
    arg, tag = _build.prg_arg(prg, 4)
    if dev.type == "cpu":
        return dcf_expand_packed_plain(roots, acc, cw_rows, prg, group_mode,
                                       vmask, final)
    L = cw_rows.shape[0]
    n = roots.shape[0] << L
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    acc_out = torch.empty((n, acc.shape[1]), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.int32, device=dev) if final else None
    fn = _build.function("dcf_eval_all", "fss_dcf_expand", _DCF_EXPAND_ARGS)
    _build.launch(
        "dcf_eval_all", fn, roots.data_ptr(), acc.data_ptr(),
        cw_rows.data_ptr(), cw_rows.stride(0), out.data_ptr(),
        acc_out.data_ptr(), t.data_ptr() if final else None, roots.shape[0],
        L, dcf_cuda.MODES.index(group_mode),
        *(int(m) & blk.MASK32 for m in vmask), arg, device=dev,
        kernel="dcf_eval_all" + tag)
    return (out, t, acc_out) if final else (out, acc_out)


def dcf_expand_packed_plain(roots, acc, cw_rows, prg,
                            group_mode: str = "wrap", vmask=dcf_cuda.FULL,
                            final: bool = False):
    """Plain PyTorch version of :func:`dcf_expand_packed`, on any
    device."""
    _check_dcf(roots, acc, cw_rows, prg, group_mode)
    _build.check_prg(prg, 4)
    add = dcf_cuda.accumulator(group_mode, vmask)
    s, t = _tree.split_seed(roots)
    v = u64(acc)
    for row in cw_rows:
        s, t, v = _dcf.expand_level(prg, s, t, v, row, add)
    return (s, t, i32(v)) if final else (blk.set_lsb(s, t), i32(v))


def dcf_expand_leaves(prg4, in_bits: int, party: int, s0: torch.Tensor,
                      cws: torch.Tensor, group_mode: str = "wrap",
                      vmask=dcf_cuda.FULL, expand=dcf_expand_packed):
    """Expand one DCF key to its leaf layer: (seeds [2^n, 4], t [2^n],
    acc [2^n, 4 or 5]) in x order. ``expand`` is the per-launch step (the
    plain version can be passed to time the same sequence without the
    kernel)."""
    nodes = blk.set_lsb(blk.clear_lsb(s0), party)[None, :].contiguous()
    acc = torch.zeros((1, dcf_cuda.acc_words(group_mode)), dtype=torch.int32,
                      device=nodes.device)
    for lo, hi in _launch_levels(in_bits, party, prg4):
        if hi == in_bits:
            return expand(nodes, acc, cws[lo:hi], prg4, group_mode, vmask,
                          final=True)
        nodes, acc = expand(nodes, acc, cws[lo:hi], prg4, group_mode, vmask)


def dcf_eval_all(prg4, group, in_bits: int, party: int, s0: torch.Tensor,
                 cws: torch.Tensor) -> torch.Tensor:
    """Full-domain DCF evaluation of one key: [2^in_bits, 4] shares in x
    order, for every group. ``prg4`` is the scheme's mul=4 PRG (ChaCha or
    AesMmo)."""
    s, t, acc = dcf_expand_leaves(prg4, in_bits, party, s0, cws,
                                  dcf_cuda.group_mode(group),
                                  dcf_cuda.value_mask(group))
    return dcf_cuda.finalize(group, party, acc, s, t, cws[in_bits, 4:8])


# ---------------------------------------------------------------------------
# Half-Tree
# ---------------------------------------------------------------------------

def ht_expand_packed(roots: torch.Tensor, cw_rows: torch.Tensor, prg,
                     hash_key, final: bool = False):
    """Expand Half-Tree nodes [N, 4] by L = cw_rows.shape[0] levels (1..3)
    with ``prg`` (ChaCha or AesMmo, mul=1) as the CCR hash.

    cw_rows: [L, 8] (or [L, >=5]) int32 key rows of those levels. Without
    ``final`` each row is a doubling level, and the nodes [N << L, 4] come
    back in x order. With ``final`` the last row is the conversion level
    (SetLsb(HCW, LCW_0), LCW_1), and the leaves come back in x order as
    (high [N << L, 4] with the clamped bit clear, low [N << L]).
    """
    dev = _check(roots, cw_rows, prg)
    arg, tag = _build.prg_arg(prg, 1)
    if dev.type == "cpu":
        return ht_expand_packed_plain(roots, cw_rows, prg, hash_key, final)
    L = cw_rows.shape[0]
    n = roots.shape[0] << L
    out = torch.empty((n, 4), dtype=torch.int32, device=dev)
    low = torch.empty((n,), dtype=torch.int32, device=dev) if final else None
    fn = _build.function("ht_eval_all", "fss_ht_expand", _HT_EXPAND_ARGS)
    _build.launch(
        "ht_eval_all", fn, roots.data_ptr(), cw_rows.data_ptr(),
        cw_rows.stride(0), out.data_ptr(), low.data_ptr() if final else None,
        roots.shape[0], L, int(final), *ht_cuda.hash_words(hash_key), arg,
        device=dev, kernel="ht_eval_all" + tag)
    return (out, low) if final else out


def ht_expand_packed_plain(roots, cw_rows, prg, hash_key,
                           final: bool = False):
    """Plain PyTorch version of :func:`ht_expand_packed`, on any device."""
    _check(roots, cw_rows, prg)
    _build.check_prg(prg, 1)
    hk = ht_cuda.hash_block(hash_key, roots.device)
    nodes = roots
    for row in cw_rows[:-1] if final else cw_rows:
        nodes = _ht.expand_level(prg, hk, nodes, row[0:4])
    return _ht.convert_both(prg, hk, nodes, cw_rows[-1]) if final else nodes


def ht_expand_leaves(prg1, in_bits: int, party: int, hash_key,
                     s0: torch.Tensor, cws: torch.Tensor,
                     expand=ht_expand_packed):
    """Expand one Half-Tree key to its leaves: (high [2^n, 4], low [2^n])
    in x order. ``expand`` is the per-launch step (the plain version can
    be passed to time the same sequence without the kernel)."""
    nodes = blk.set_lsb(s0, party)[None, :].contiguous()
    for lo, hi in _launch_levels(in_bits, party, prg1):
        nodes = expand(nodes, cws[lo:hi], prg1, hash_key,
                       final=hi == in_bits)
    return nodes


def ht_eval_all(prg1, group, in_bits: int, party: int, hash_key,
                s0: torch.Tensor, cws: torch.Tensor,
                ocw: torch.Tensor) -> torch.Tensor:
    """Full-domain Half-Tree evaluation of one key: [2^in_bits, 4] shares
    in x order. ``prg1`` is the scheme's mul=1 PRG (ChaCha or AesMmo)."""
    high, low = ht_expand_leaves(prg1, in_bits, party, hash_key, s0, cws)
    return _dpf.finalize_leaves(group, party, high, low, ocw)


# ---------------------------------------------------------------------------
# VDPF
# ---------------------------------------------------------------------------

def vdpf_eval_all(prg2, hashes, group, in_bits: int, party: int,
                  s0: torch.Tensor, cws: torch.Tensor, cs: torch.Tensor,
                  ocw: torch.Tensor, fold: str = "reference"):
    """Full-domain VDPF evaluation of one key and its proof: (ys
    [2^in_bits, 4] shares in x order, pi [4, 4]).

    Counterpart of ``eval_all_pallas.vdpf_eval_all_chunked``: the DPF's
    expansion kernel for every level (no threshold), the DPF's finalize,
    pi~ of the whole domain through the XorHash kernel (x as lane 0), the
    t ? cs : 0 correction in place, and ``fold``: "reference" (the flat
    chain, one thread), "tree" (one H' launch a level) or "chunked". Both
    parties must use the same fold. cws are VDPF rows [in_bits, 8].
    """
    s, t = expand_leaves(prg2, in_bits, party, s0, cws)
    return _vdpf.leaf_outputs(
        lambda a, b: vdpf_cuda.xor_hash(hashes, a, b),
        lambda pts, c: vdpf_cuda.fold(hashes, pts, c, fold), group, party,
        s, t, cs, ocw)
