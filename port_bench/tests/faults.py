"""Faults planted under the timed path, for the tests that see ``correct``
come out false; and the launch counting of the port's plain versions, so
that a sound CPU run shows its kernel path ran.

Each function patches the port in the process that calls it; ``put``
defaults to ``setattr`` (pass pytest's ``monkeypatch.setattr`` to undo it
after a test).
"""

from __future__ import annotations

import functools

import torch


def count_plain_launches(put=setattr) -> None:
    """Count each plain version's call under its kernel, as the kernels'
    wrappers count their launches."""
    from fss_tpu_torch import _build
    from fss_tpu_torch.ops import dcf_cuda

    def counted(fn, kernel):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            _build.launches[kernel] += 1
            return fn(*args, **kwargs)
        return call

    put(dcf_cuda, "eval_packed_plain",
        counted(dcf_cuda.eval_packed_plain, "dcf_eval"))
    put(dcf_cuda, "gen_packed_plain",
        counted(dcf_cuda.gen_packed_plain, "dcf_gen"))


def _unchanged(out):
    return torch.zeros_like(out)  # the output buffer as it was


def _half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0  # the second half never computed
    return out


def _altered(out):
    out = out.clone()
    out.view(-1)[0] ^= 1  # one word of one answer
    return out


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def plant(cls, method: str, fault: str, put=setattr) -> None:
    """Make ``cls.method`` return its output with ``fault`` applied."""
    orig = getattr(cls, method)

    @functools.wraps(orig)
    def broken(*args, **kwargs):
        return FAULTS[fault](orig(*args, **kwargs))
    put(cls, method, broken)

