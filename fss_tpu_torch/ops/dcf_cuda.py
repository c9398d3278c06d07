"""Batched DCF point evaluation and Gen on the card: wrappers of the CUDA
kernels ``csrc/dcf_eval.cu`` and ``csrc/dcf_gen.cu``.

Counterpart of ``fss_tpu.ops.dcf_pallas`` and of the DCF half of
``fss_tpu.ops.aes_pallas``. The kernels replace ``dcf_pallas.eval_packed``
and ``dcf_pallas.gen_packed`` with the ChaCha PRG, and
``aes_pallas._dcf_eval_call`` and ``aes_pallas.dcf_gen_packed`` with
AES-128-MMO: each wrapper takes the PRG object (``prg``, ChaCha or AesMmo
with mul=4). Each source file says what bounds it on the H100 and what
its design does about that.

Dispatch is by the tensors' device only: CUDA tensors go to the kernel
(a failing build or launch raises), CPU tensors to the plain PyTorch
version beside each wrapper (``*_plain``), which computes the same
function and is what the CPU tests and the card's kernel checks compare
with. Both kernels take every group of the port and every ``in_bits`` in
1..128; the group decides a mode, one per algebra
(``groups.group_mode``: xor, wrap, mod64, mod128, mod128np).

The Eval kernel accumulates the path value raw in that mode (a 5-word
exact sum for mod128np, 4 words otherwise; ``csrc/dcf_acc.cuh``). On the
card :func:`eval_points` is one launch, :func:`eval_shares`: the kernel's
epilogue turns the accumulator, final seed and t into the share
(``dcf_acc.cuh: dcf_share``). :func:`eval_packed` returns them raw, and
:func:`finalize`, elementwise torch glue as in the JAX package, turns them
into the share on the CPU path and in the plain versions. The Gen kernel
does the group arithmetic itself (``csrc/group.cuh``) and writes whole
wire rows [B, in_bits+1, 8].

The TPU staging ([T, 128] tiles, ``pack_keys``, ``block_rows``) does not
carry over: the Eval kernel reads wire rows [B, in_bits+1, 8] in place
through strides, or one broadcast key [in_bits+1, 8] (key stride 0).
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.block import MASK32, i32, u64
from fss_tpu_torch.groups import MODES, bits_mask, gen_params, group_mode
from fss_tpu_torch.ops.dpf_cuda import _device, _x_lanes
from fss_tpu_torch.schemes import dcf as _dcf
from fss_tpu_torch.utils.profiling import span

FULL = (MASK32,) * 4
NOT_ONE = MASK32 ^ 1

_EVAL_ARGS = (_build.P, _build.I64, _build.P, _build.I64, _build.I64,
              _build.I64, _build.P, _build.INT, _build.P, _build.P,
              _build.P, _build.P, _build.I64, _build.INT, _build.INT,
              _build.INT, *(_build.U32,) * 12, _build.P, _build.P)
_NO_GROUP = ((0,) * 4, (0,) * 4)  # fss::Group of the raw epilogue: unread
_GEN_ARGS = (_build.P, _build.P, _build.I64, _build.P, _build.P,
             _build.I64, _build.INT, _build.INT, _build.INT,
             *(_build.U32,) * 8, _build.P, _build.P)


# ---------------------------------------------------------------------------
# Group modes
# ---------------------------------------------------------------------------

def value_mask(group) -> tuple:
    """The mask the Eval kernels apply to each value contribution before
    the add: none for xor and wrap (the finalize masks), the group's bits
    for mod64, the clamped bit for the 128-bit modes (which then decode)."""
    mode = group_mode(group)
    if mode in ("xor", "wrap"):
        return FULL
    if mode == "mod64":
        return bits_mask(group.bits)
    return (MASK32, MASK32, MASK32, NOT_ONE)


def acc_words(mode: str) -> int:
    """Accumulator words: 5 (a 160-bit exact sum) for mod128np, else 4."""
    return 5 if mode == "mod128np" else 4


# ---------------------------------------------------------------------------
# The raw accumulator, plain (csrc/dcf_acc.cuh on int64 lanes)
# ---------------------------------------------------------------------------

def _vfix(mode: str, vmask, c: torch.Tensor) -> torch.Tensor:
    """Mask, and for 128-bit groups decode, [..., 4] int64 contributions."""
    if mode in ("xor", "wrap"):
        return c
    c = c & torch.tensor(vmask, dtype=torch.int64, device=c.device)
    if mode in ("mod128", "mod128np"):
        c = torch.cat([c[..., :3], c[..., 3:] >> 1], dim=-1)
    return c


def _acc_add(mode: str, acc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """acc [..., 4 or 5] += c [..., 4], int64 lanes in [0, 2^32)."""
    if mode == "xor":
        return acc ^ c
    out, carry = [], 0
    for i in range(acc.shape[-1]):
        s = acc[..., i] + (c[..., i] if i < 4 else 0) + carry
        carry = s >> 32
        out.append(s & MASK32)
    return torch.stack(out, dim=-1)


def accumulator(mode: str, vmask):
    """The kernels' value step as a plain ``add`` for ``schemes.dcf``:
    acc += vfix(v_sel) + vfix(v_cw_t), on int64 lanes."""
    def add(acc, v_sel, v_cw_t):
        for c in (v_sel, v_cw_t):
            acc = _acc_add(mode, acc, _vfix(mode, vmask, u64(c)))
        return acc
    return add


def acc_to_value(group, v_raw: torch.Tensor) -> torch.Tensor:
    """The kernels' raw accumulator [B, 4 or 5] -> group values [B, 4]."""
    mode = group_mode(group)
    if mode in ("xor", "wrap"):
        return group.from_block(v_raw)
    v = u64(v_raw)
    if mode == "mod128":
        # Decoded lanes; the wrapped sum's residue mod a power of two that
        # divides 2^128 is exact.
        return i32(groups._mask_to_bits(v, group.mod.bit_length() - 1))
    if mode == "mod64":
        # The exact sum of <= 2 * 128 terms below 2^bits.
        return i32(groups._mod_reduce(v, group.mod,
                                      min(group.bits + 8, 128)))
    # mod128np: v is the exact 160-bit sum (< 2^135). Reduce the low 128
    # bits by long division, then fold the high word (< 2^8) in with
    # 2^128 mod m by double-and-add; every partial stays below 2 m < 2^128.
    m = groups._const128(group.mod, v[..., :4])
    c128 = groups._const128((1 << 128) % group.mod, m)

    def cond_sub(s):
        return torch.where(groups._ge128(s, m)[..., None],
                           groups._sub128(s, m), s)

    lo = groups._mod_reduce(v[..., :4], group.mod, 128)
    hi = v[..., 4]
    r = torch.zeros_like(lo)
    for b in range(7, -1, -1):
        r = cond_sub(groups._add128(r, r))
        bit = ((hi >> b) & 1).bool()[..., None]
        r = cond_sub(groups._add128(r, torch.where(bit, c128,
                                                   torch.zeros_like(r))))
    return i32(cond_sub(groups._add128(lo, r)))


@span("ops.dcf.finalize")
def finalize(group, party: int, vo, so, t, v_last) -> torch.Tensor:
    """Group-convert kernel outputs to [B, 4] shares:
    y = +-(acc_to_value(vo) + s + (t ? v_last : 0)). ``v_last`` is [4] or
    per-key [B, 4]."""
    v = acc_to_value(group, vo)
    if party:
        v = group.neg(v)
    return _dcf.finalize_leaves(group, party, so, t, v, v_last)


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def _check_in_bits(in_bits: int) -> None:
    if not 1 <= in_bits <= 128:
        raise ValueError(f"in_bits must be in 1..128, got {in_bits}")


def _check_eval(s0, cws, xs, in_bits, party, group_mode):
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    if group_mode not in MODES:
        raise ValueError(f"group_mode must be one of {MODES}, got "
                         f"{group_mode!r}")
    _check_in_bits(in_bits)
    B = xs.shape[0]
    dev = _device(s0, cws, xs)
    _build.check(s0, "s0", dev, [(B, 4), (4,)])
    _build.check(cws, "cws", dev, [(B, in_bits + 1, 8), (in_bits + 1, 8)])
    _build.check(xs, "xs", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    return dev


@span("ops.dcf.eval_packed")
def eval_packed(s0: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor,
                in_bits: int, party: int, prg, group_mode: str = "wrap",
                vmask=FULL):
    """The DCF tree walk for a batch of keys, with ``prg`` (ChaCha or
    AesMmo, mul=4).

    s0: [B, 4] seeds or one [4] seed; cws: wire rows [B, in_bits+1, 8] or
    one key [in_bits+1, 8]; xs: [B], or [B, 4] lanes (required for
    in_bits > 32). All int32. ``group_mode`` and ``vmask`` come from
    :func:`group_mode` and :func:`value_mask`. Returns (vo [B, 4 or 5] raw
    accumulator, so [B, 4] final seeds with the clamped bit clear, t [B]
    control bits).
    """
    dev = _check_eval(s0, cws, xs, in_bits, party, group_mode)
    arg, tag = _build.prg_arg(prg, 4)
    if dev.type == "cpu":
        return eval_packed_plain(s0, cws, xs, in_bits, party, prg,
                                 group_mode, vmask)
    B = xs.shape[0]
    vo = torch.empty((B, acc_words(group_mode)), dtype=torch.int32,
                     device=dev)
    so = torch.empty((B, 4), dtype=torch.int32, device=dev)
    t = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch_eval(s0, cws, xs, in_bits, party, arg, tag, group_mode, vmask,
                 _NO_GROUP, (vo, so, t, None))
    return vo, so, t


def _launch_eval(s0, cws, xs, in_bits, party, arg, tag, mode, vmask,
                 group_params, outs) -> None:
    """One ``dcf_eval`` launch; outs: (vo, so, t, None) for the raw
    epilogue, (None, None, None, shares) for the shares."""
    mask, mod = group_params
    fn = _build.function("dcf_eval", "fss_dcf_eval", _EVAL_ARGS)
    _build.launch(
        "dcf_eval", fn, s0.data_ptr(), 4 if s0.dim() == 2 else 0,
        cws.data_ptr(), 8, 1, (in_bits + 1) * 8 if cws.dim() == 3 else 0,
        xs.data_ptr(), int(xs.dim() == 2),
        *(None if o is None else o.data_ptr() for o in outs), xs.shape[0],
        in_bits, int(party), MODES.index(mode),
        *(int(m) & MASK32 for m in vmask), *mask, *mod, arg,
        device=xs.device, kernel="dcf_eval" + tag)


def eval_packed_plain(s0, cws, xs, in_bits: int, party: int, prg,
                      group_mode: str = "wrap", vmask=FULL):
    """Plain PyTorch version of :func:`eval_packed` (same inputs, same
    outputs), on any device."""
    _check_eval(s0, cws, xs, in_bits, party, group_mode)
    _build.check_prg(prg, 4)
    B = xs.shape[0]
    wide = cws.expand(B, in_bits + 1, 8)
    acc = torch.zeros((B, acc_words(group_mode)), dtype=torch.int64,
                      device=xs.device)
    s, t, acc = _dcf.walk(prg, in_bits, party,
                          s0.expand(B, 4), lambda i: wide[:, i],
                          blk.input_bits_msb_first(_x_lanes(xs), in_bits),
                          acc, accumulator(group_mode, vmask))
    return i32(acc), s, t


@span("ops.dcf.eval_shares")
def eval_shares(s0: torch.Tensor, cws: torch.Tensor, xs: torch.Tensor,
                in_bits: int, party: int, prg, group) -> torch.Tensor:
    """The DCF tree walk and its finalize in one launch, with ``prg``
    (ChaCha or AesMmo, mul=4): [B, 4] int32 shares of ``group``, those of
    :func:`finalize` over :func:`eval_packed`'s outputs. Inputs as
    :func:`eval_packed`'s."""
    mode = group_mode(group)
    dev = _check_eval(s0, cws, xs, in_bits, party, mode)
    arg, tag = _build.prg_arg(prg, 4)
    if dev.type == "cpu":
        return eval_shares_plain(s0, cws, xs, in_bits, party, prg, group)
    shares = torch.empty((xs.shape[0], 4), dtype=torch.int32, device=dev)
    _launch_eval(s0, cws, xs, in_bits, party, arg, tag, mode,
                 value_mask(group), gen_params(group),
                 (None, None, None, shares))
    return shares


def eval_shares_plain(s0, cws, xs, in_bits: int, party: int, prg,
                      group) -> torch.Tensor:
    """Plain PyTorch version of :func:`eval_shares`, on any device."""
    vo, so, t = eval_packed_plain(s0, cws, xs, in_bits, party, prg,
                                  group_mode(group), value_mask(group))
    return finalize(group, party, vo, so, t, cws[..., in_bits, 4:8])


def eval_points(prg, group, in_bits: int, party: int, s0, cws,
                xs) -> torch.Tensor:
    """Point evaluation against wire keys: on the card one launch of
    :func:`eval_shares`; on the CPU the walk, then :func:`finalize`."""
    if xs.device.type == "cuda":
        return eval_shares(s0, cws, xs, in_bits, party, prg, group)
    vo, so, t = eval_packed(s0, cws, xs, in_bits, party, prg,
                            group_mode(group), value_mask(group))
    return finalize(group, party, vo, so, t, cws[..., in_bits, 4:8])


# ---------------------------------------------------------------------------
# Gen
# ---------------------------------------------------------------------------

def _check_gen(s0s, alphas, betas, in_bits, pred):
    if pred not in ("lt", "gt"):
        raise ValueError(f"pred must be 'lt' or 'gt', got {pred!r}")
    _check_in_bits(in_bits)
    B = s0s.shape[0]
    dev = _device(s0s, alphas, betas)
    _build.check(s0s, "s0s", dev, [(B, 2, 4)])
    _build.check(alphas, "alphas", dev,
                 [(B, 4)] if in_bits > 32 else [(B,), (B, 4)])
    _build.check(betas, "betas", dev, [(B, 4)])
    return dev


@span("ops.dcf.gen_packed")
def gen_packed(s0s: torch.Tensor, alphas: torch.Tensor, betas: torch.Tensor,
               in_bits: int, prg, pred: str, group) -> torch.Tensor:
    """Every level of DCF Gen, and the final value CW, for a batch of keys,
    with ``prg`` (ChaCha or AesMmo, mul=4).

    s0s [B, 2, 4] seeds; alphas [B], or [B, 4] lanes (required for
    in_bits > 32); betas [B, 4]. Returns wire rows cws [B, in_bits+1, 8].
    """
    dev = _check_gen(s0s, alphas, betas, in_bits, pred)
    arg, tag = _build.prg_arg(prg, 4)
    if dev.type == "cpu":
        return gen_packed_plain(s0s, alphas, betas, in_bits, prg, pred,
                                group)
    B = s0s.shape[0]
    cws = torch.empty((B, in_bits + 1, 8), dtype=torch.int32, device=dev)
    mask, mod = gen_params(group)
    fn = _build.function("dcf_gen", "fss_dcf_gen", _GEN_ARGS)
    _build.launch(
        "dcf_gen", fn, s0s.data_ptr(), alphas.data_ptr(),
        4 if alphas.dim() == 2 else 1, betas.data_ptr(), cws.data_ptr(), B,
        in_bits, int(pred == "lt"), MODES.index(group_mode(group)), *mask,
        *mod, arg, device=dev, kernel="dcf_gen" + tag)
    return cws


def gen_packed_plain(s0s, alphas, betas, in_bits: int, prg, pred: str,
                     group) -> torch.Tensor:
    """Plain PyTorch version of :func:`gen_packed`, on any device."""
    _check_gen(s0s, alphas, betas, in_bits, pred)
    _build.check_prg(prg, 4)
    return _dcf.gen(prg, group, in_bits, pred, s0s, _x_lanes(alphas), betas)


def gen_batch(prg, group, in_bits: int, pred: str, s0s, alphas,
              betas) -> torch.Tensor:
    """Batched Gen into wire rows [B, in_bits+1, 8]."""
    return gen_packed(s0s, alphas, betas, in_bits, prg, pred, group)
