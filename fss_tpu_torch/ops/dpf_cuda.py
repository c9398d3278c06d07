"""Batched DPF point evaluation and Gen on the card: wrappers of the CUDA
kernels ``csrc/dpf_eval.cu`` and ``csrc/dpf_gen.cu``.

Counterpart of ``fss_tpu.ops.dpf_pallas`` and of the DPF half of
``fss_tpu.ops.aes_pallas``. The kernels replace ``dpf_pallas.eval_packed``
and ``dpf_pallas.gen_packed`` with the ChaCha PRG, and
``aes_pallas.eval_packed`` and ``aes_pallas.gen_packed`` with AES-128-MMO:
each wrapper takes the PRG object (``prg``, ChaCha or AesMmo with mul=2),
and the kernel's instantiation follows it. Each source file says what
bounds it on the H100 and what its design does about that.

Dispatch is by the tensors' device only: CUDA tensors go to the kernel
(a failing build or launch raises), CPU tensors to the plain PyTorch
version beside each wrapper (``*_plain``), which computes the same
function and is what the CPU tests and the card's kernel checks compare
with. The Gen kernel ends with the group-typed output CW when it is given
betas and the group (``csrc/group.cuh``), so ``gen_batch`` is one launch;
the Eval finalize is elementwise glue outside the kernel, as in the JAX
package.

Key layouts:

  - wire rows [B, in_bits+1, 8] (the reference's layout; the eval kernel
    reads them in place through strides), or one broadcast key
    [in_bits+1, 8];
  - packed planes [in_bits, 5, B] plus ocw [B, 4] (``PackedDpfKeys``):
    only the 5 used words, neighbouring keys on neighbouring words.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.schemes import dpf as _dpf
from fss_tpu_torch.utils.profiling import span

_EVAL_ARGS = (_build.P, _build.I64, _build.P, _build.I64, _build.I64,
              _build.I64, _build.P, _build.I64, _build.P, _build.P,
              _build.I64, _build.INT, _build.INT, _build.P, _build.P)
_GEN_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P, _build.P,
             _build.INT, _build.INT, _build.P, _build.P, _build.P, _build.P,
             _build.I64, _build.INT, _build.INT, *(_build.U32,) * 8,
             _build.P, _build.P)


def _device(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _x_lanes(xs: torch.Tensor) -> torch.Tensor:
    """[B] or [B, 4] kernel-layout inputs -> [B, 4] lanes."""
    if xs.dim() == 2:
        return xs
    return torch.cat([xs[:, None], torch.zeros(
        (xs.shape[0], 3), dtype=torch.int32, device=xs.device)], dim=1)


def _check_eval(s0, cws, xs, in_bits, party, packed):
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    B = xs.shape[0]
    dev = _device(s0, cws, xs)
    _build.check(s0, "s0", dev, [(B, 4), (4,)])
    _build.check(cws, "cws", dev, [(in_bits, 5, B)] if packed else
                 [(B, in_bits + 1, 8), (in_bits + 1, 8)])
    _build.check(xs, "xs", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    if not 1 <= in_bits <= 128:
        raise ValueError(f"in_bits must be in 1..128, got {in_bits}")
    return dev


@span("ops.dpf.eval_packed")
def eval_packed(s0: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor,
                in_bits: int, party: int, prg, packed: bool = False):
    """The DPF tree walk for a batch of keys, with ``prg`` (ChaCha or
    AesMmo, mul=2).

    s0: [B, 4] seeds or one [4] seed; cws: wire rows [B, in_bits+1, 8] or
    one key [in_bits+1, 8] (``packed=False``), or planes [in_bits, 5, B]
    (``packed=True``); xs: [B], or [B, 4] lanes (required for
    in_bits > 32). All int32. Returns (so [B, 4] final seeds with the
    clamped bit clear, t [B] control bits).
    """
    dev = _check_eval(s0, cws, xs, in_bits, party, packed)
    arg, tag = _build.prg_arg(prg, 2)
    if dev.type == "cpu":
        return eval_packed_plain(s0, cws, xs, in_bits, party, prg, packed)
    B = xs.shape[0]
    so = torch.empty((B, 4), dtype=torch.int32, device=dev)
    t = torch.empty((B,), dtype=torch.int32, device=dev)
    if packed:
        strides = (5 * B, B, 1)
    else:
        strides = (8, 1, (in_bits + 1) * 8 if cws.dim() == 3 else 0)
    fn = _build.function("dpf_eval", "fss_dpf_eval", _EVAL_ARGS)
    _build.launch(
        "dpf_eval", fn, s0.data_ptr(), 4 if s0.dim() == 2 else 0,
        cws.data_ptr(), *strides, xs.data_ptr(), 4 if xs.dim() == 2 else 1,
        so.data_ptr(), t.data_ptr(), B, in_bits, int(party), arg,
        device=dev, kernel="dpf_eval" + tag)
    return so, t


def eval_packed_plain(s0, cws, xs, in_bits: int, party: int, prg,
                      packed: bool = False):
    """Plain PyTorch version of :func:`eval_packed` (same inputs, same
    outputs), on any device."""
    _check_eval(s0, cws, xs, in_bits, party, packed)
    _build.check_prg(prg, 2)
    B = xs.shape[0]
    if packed:
        def cw_level(i):
            return cws[i].T
    else:
        wide = cws.expand(B, in_bits + 1, 8)

        def cw_level(i):
            return wide[:, i]
    x_bits = blk.input_bits_msb_first(_x_lanes(xs), in_bits)
    return _dpf.walk(prg, in_bits, party, s0.expand(B, 4), cw_level, x_bits)


@span("ops.dpf.finalize")
def finalize(group, party: int, so: torch.Tensor, t: torch.Tensor,
             ocw: torch.Tensor) -> torch.Tensor:
    """Group-convert kernel outputs to [B, 4] shares."""
    return _dpf.finalize_leaves(group, party, so, t, ocw)


def eval_points(prg, group, in_bits: int, party: int, s0, cws,
                xs) -> torch.Tensor:
    """Point evaluation against wire keys: kernel walk + finalize."""
    so, t = eval_packed(s0, cws, xs, in_bits, party, prg)
    return finalize(group, party, so, t, cws[..., in_bits, 0:4])


def eval_points_packedkey(prg, group, in_bits: int, party: int, s0, cws_p,
                          ocw, xs) -> torch.Tensor:
    """Point evaluation against a packed key: planes [in_bits, 5, B] and
    ocw [B, 4]. Bit-exact with the wire path."""
    so, t = eval_packed(s0, cws_p, xs, in_bits, party, prg, packed=True)
    return finalize(group, party, so, t, ocw)


def pack_keys(cws: torch.Tensor, in_bits: int):
    """Wire rows [B, in_bits+1, 8] -> (planes [in_bits, 5, B], ocw [B, 4])."""
    return (cws[:, :in_bits, :5].permute(1, 2, 0).contiguous(),
            cws[:, in_bits, 0:4].contiguous())


def wire_rows(in_bits: int, cws_p: torch.Tensor,
              ocw: torch.Tensor) -> torch.Tensor:
    """Packed planes [in_bits, 5, B] + ocw [B, 4] -> wire rows
    [B, in_bits+1, 8]."""
    B = ocw.shape[0]
    out = torch.zeros((B, in_bits + 1, 8), dtype=torch.int32,
                      device=ocw.device)
    out[:, :in_bits, :5] = cws_p.permute(2, 0, 1)
    out[:, in_bits, :4] = ocw
    return out


# ---------------------------------------------------------------------------
# Gen
# ---------------------------------------------------------------------------

def _check_gen(s0s, alphas, in_bits, layout, ocw_row, betas, group):
    if layout not in ("wire", "packed"):
        raise ValueError(f"layout must be 'wire' or 'packed', got {layout}")
    if (betas is None) != (group is None):
        raise ValueError("the output CW needs both betas and the group")
    if betas is not None and not ocw_row:
        raise ValueError("the output CW needs the output row")
    B = s0s.shape[0]
    dev = _device(s0s, alphas, *(() if betas is None else (betas,)))
    _build.check(s0s, "s0s", dev, [(B, 2, 4)])
    _build.check(alphas, "alphas", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    if betas is not None:
        _build.check(betas, "betas", dev, [(B, 4)])
    if not 1 <= in_bits <= 128:
        raise ValueError(f"in_bits must be in 1..128, got {in_bits}")
    return dev


@span("ops.dpf.gen_packed")
def gen_packed(s0s: torch.Tensor, alphas: torch.Tensor, in_bits: int, prg,
               layout: str = "wire", ocw_row: bool = True, betas=None,
               group=None):
    """All levels of BGI Gen for a batch of keys, with ``prg`` (ChaCha or
    AesMmo, mul=2), and the output CW given ``betas`` and ``group``.

    s0s [B, 2, 4] seeds; alphas [B], or [B, 4] lanes (required for
    in_bits > 32); betas [B, 4] or None. Returns (cws, s0f [B, 4], s1f
    [B, 4], t0 [B], t1 [B]): ``cws`` is wire rows (``layout="wire"``) or
    (planes [in_bits, 5, B], ocw [B, 4]) (``layout="packed"``). Wire rows
    are [B, in_bits+1, 8] with the output CW in the last row, or
    [B, in_bits, 8] without it (``ocw_row=False``, the VDPF's keys, no
    betas). Without betas the output CW is zero.
    """
    dev = _check_gen(s0s, alphas, in_bits, layout, ocw_row, betas, group)
    arg, tag = _build.prg_arg(prg, 2)
    if dev.type == "cpu":
        return gen_packed_plain(s0s, alphas, in_bits, prg, layout, ocw_row,
                                betas, group)
    B = s0s.shape[0]
    rows = in_bits + int(ocw_row)
    shape = (B, rows, 8) if layout == "wire" else (in_bits, 5, B)
    cws = torch.empty(shape, dtype=torch.int32, device=dev)
    ocw = (torch.empty((B, 4), dtype=torch.int32, device=dev)
           if layout == "packed" else None)
    s0f = torch.empty((B, 4), dtype=torch.int32, device=dev)
    s1f = torch.empty((B, 4), dtype=torch.int32, device=dev)
    t0 = torch.empty((B,), dtype=torch.int32, device=dev)
    t1 = torch.empty((B,), dtype=torch.int32, device=dev)
    mode = groups.group_mode(group) if group is not None else "xor"
    mask, mod = groups.gen_params(group) if group is not None else \
        ((0,) * 4, (0,) * 4)
    fn = _build.function("dpf_gen", "fss_dpf_gen", _GEN_ARGS)
    _build.launch(
        "dpf_gen", fn, s0s.data_ptr(), alphas.data_ptr(),
        4 if alphas.dim() == 2 else 1,
        None if betas is None else betas.data_ptr(), cws.data_ptr(),
        None if ocw is None else ocw.data_ptr(), int(layout == "wire"),
        rows, s0f.data_ptr(), s1f.data_ptr(), t0.data_ptr(), t1.data_ptr(),
        B, in_bits, groups.MODES.index(mode), *mask, *mod, arg, device=dev,
        kernel="dpf_gen" + tag)
    return (cws if ocw is None else (cws, ocw)), s0f, s1f, t0, t1


def gen_packed_plain(s0s, alphas, in_bits: int, prg, layout: str = "wire",
                     ocw_row: bool = True, betas=None, group=None):
    """Plain PyTorch version of :func:`gen_packed`, on any device."""
    _check_gen(s0s, alphas, in_bits, layout, ocw_row, betas, group)
    _build.check_prg(prg, 2)
    a_bits = blk.input_bits_msb_first(_x_lanes(alphas), in_bits)
    rows, s0, s1, t0, t1 = _dpf.gen_levels(prg, in_bits, s0s, a_bits)
    planes = torch.stack(rows, dim=0).permute(0, 2, 1).contiguous()
    B = s0s.shape[0]
    ocw = (torch.zeros((B, 4), dtype=torch.int32, device=s0s.device)
           if betas is None else _dpf.output_cw(group, s0, s1, t1, betas))
    if layout == "packed":
        return (planes, ocw), s0, s1, t0, t1
    cws = wire_rows(in_bits, planes, ocw)
    return (cws if ocw_row else cws[:, :in_bits].contiguous()), s0, s1, t0, t1


def output_cw(group, s0f, s1f, t1, betas) -> torch.Tensor:
    """The group-typed final CW from the Gen's leaf outputs (plain)."""
    return _dpf.output_cw(group, s0f, s1f, t1, betas)


def gen_batch(prg, group, in_bits: int, s0s, alphas,
              betas) -> torch.Tensor:
    """Batched Gen into wire rows [B, in_bits+1, 8], the output CW in the
    last row: one launch."""
    return gen_packed(s0s, alphas, in_bits, prg, "wire", betas=betas,
                      group=group)[0]


def gen_batch_packed(prg, group, in_bits: int, s0s, alphas, betas):
    """Batched Gen into the packed key layout: (planes [in_bits, 5, B],
    ocw [B, 4]), one launch."""
    return gen_packed(s0s, alphas, in_bits, prg, "packed", betas=betas,
                      group=group)[0]
