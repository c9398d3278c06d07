"""Two-server PIR's contraction on the card: wrapper of the CUDA kernel
``csrc/pir_contract.cu``.

A server's answer shares to Q queries over one table of 32-bit words,
``ans[q] = sum_j sel[q, j] * db[j]`` (mod 2^32), sel[q] being its selector
shares of query q (the Uint(32) DPF EvalAll's word 0 a leaf). The kernel
reads the table once for the whole batch, and each selector word once.
Counterpart of the JAX package's XLA expression ``(sel[:, None] *
db).sum(axis=0, dtype=int32)``, one query a pass.

CUDA tensors go to the kernel (a failing build or launch raises), CPU
tensors to :func:`contract_plain`.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.utils.profiling import span

MAX_QUERIES = 64  # csrc/pir_contract.cu: kMaxQueries

_ARGS = (_build.P, _build.I64, _build.I64, _build.P, _build.I64, _build.INT,
         _build.INT, _build.INT, _build.P, _build.P)

# Rows a block of the plain version, at most: each product of a selector
# word and a 16-bit half of a table word is below 2^48, so a block's sums
# stay below 2^62 in int64. A block's products are at most _PLAIN_VALUES.
_PLAIN_ROWS = 1 << 14
_PLAIN_VALUES = 1 << 22


def _check(sel: torch.Tensor, db: torch.Tensor) -> torch.device:
    if sel.dim() != 2 or not 1 <= sel.shape[0] <= MAX_QUERIES:
        raise ValueError(f"sel must be [Q, N] with 1 <= Q <= {MAX_QUERIES}, "
                         f"got {tuple(sel.shape)}")
    if db.dim() != 2 or db.shape[0] != sel.shape[1] or db.shape[1] < 1:
        raise ValueError(f"db must be [{sel.shape[1]}, D] with D >= 1, got "
                         f"{tuple(db.shape)}")
    for name, t in (("sel", sel), ("db", db)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dev = db.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if sel.device != dev:
        raise ValueError(f"sel is on {sel.device}, db on {dev}")
    if not db.is_contiguous():
        raise ValueError("db must be contiguous")
    return dev


@span("ops.pir.contract")
def contract(sel: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """The [Q, D] int32 answers of selector shares ``sel`` [Q, N] against
    the table ``db`` [N, D], mod 2^32: one launch of
    ``csrc/pir_contract.cu`` on a CUDA device. ``sel`` may be any strided
    view, such as word 0 of EvalAll shares [Q, N, 4] (``ys[:, :, 0]``)."""
    dev = _check(sel, db)
    if dev.type == "cpu":
        return contract_plain(sel, db)
    (queries, rows), cols = sel.shape, db.shape[1]
    out = torch.empty((queries, cols), dtype=torch.int32, device=dev)
    wide = cols % 2 == 0 and db.data_ptr() % 8 == 0
    fn = _build.function("pir_contract", "fss_pir_contract", _ARGS)
    _build.launch("pir_contract", fn, sel.data_ptr(), sel.stride(0),
                  sel.stride(1), db.data_ptr(), rows, cols, queries,
                  int(wide), out.data_ptr(), device=dev)
    return out


def contract_plain(sel: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`contract`, on any device: int64 sums
    of the selector words times each 16-bit half of the table's words, a
    block of rows at a time, masked to 32 bits."""
    _check(sel, db)
    (queries, rows), cols = sel.shape, db.shape[1]
    step = max(1, min(_PLAIN_ROWS, _PLAIN_VALUES // (queries * cols)))
    y = blk.u64(sel)
    out = torch.zeros((queries, cols), dtype=torch.int64, device=sel.device)
    for j in range(0, rows, step):
        x = blk.u64(db[j:j + step])
        yb = y[:, j:j + step, None]
        lo = (yb * (x & 0xFFFF)).sum(1)
        hi = (yb * (x >> 16)).sum(1) & 0xFFFF  # only its low half survives
        out = (out + lo + (hi << 16)) & blk.MASK32
    return blk.i32(out)
