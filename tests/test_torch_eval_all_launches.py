"""The DPF EvalAll's launch arguments (``eval_all_cuda._dpf_launches``), on
the CPU with the launches recorded and never run: the batch builder, which
issues every key's launches in one ``_build.launch_many``, gives for each
key the launches of the per-key plan loop it replaced (kept below as
``_per_key_launches``, frozen): the same kernel, the same scalars, the
same PRG argument, and device addresses at the same offsets into the
same tensors (the seeds, the keys, the outputs, the t bits and the top
launch's node scratch). ChaCha and AES, three groups, 1 to 25 bits, both
parties, shards and a capped ``most``, the seeds epilogue
(``expand_leaves``), and batches of 3 keys."""

import ctypes

import numpy as np
import pytest
import torch

from fss_tpu_torch import _build, groups
from fss_tpu_torch.ops import dcf_cuda
from fss_tpu_torch.ops import eval_all_cuda as eac
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha

PRGS = {"chacha": ChaCha(2, (1, 2)),
        "aes": AesMmo(2, (bytes(range(16)), bytes(range(16, 32))))}
GROUPS = (groups.Uint(32), groups.Bytes(), groups.Uint(64))
BITS = (1, 2, 5, 11, 20, 25)
# (most, shard): the whole domain, a capped most, and shards of 2 and 4.
SHARDS = ((12, (0, 1)), (3, (0, 1)), (12, (1, 2)), (4, (3, 4)))
KEYS = 3


def _per_key_launches(prg2, group, in_bits, party, s0, cws, most, out,
                      t=None, r=0, k=0):
    """The plan's launches of one key (s0 [4], cws [rows, 8]) into ``out``
    (shares, or with ``t`` the seeds and t bits) of shard r of 2^k, one
    ``_build.launch`` each; the top launch's roots go to a scratch
    buffer."""
    arg, tag = _build.prg_arg(prg2, 2)
    fn = _build.function("dpf_eval_all", "fss_dpf_eval_all", eac._DPF_ARGS)
    roots = None
    for first, walk, b in eac.plan(in_bits, most):
        if roots is not None:
            roots, = eac._shard_rows(first, r, k, roots)
        if first + walk + b < in_bits:
            dst = torch.empty((1 << (first + walk + b), 4),
                              dtype=torch.int32, device=s0.device)
            epilogue = "nodes"
        else:
            dst = out
            epilogue = "seeds" if t is not None else dcf_cuda.group_mode(group)
        mask, mod = (dcf_cuda.gen_params(group) if epilogue in dcf_cuda.MODES
                     else ((0,) * 4,) * 2)
        _build.launch(
            "dpf_eval_all", fn, s0.data_ptr(),
            None if roots is None else roots.data_ptr(),
            eac._rows(cws, first), cws.stride(0), dst.data_ptr(),
            t.data_ptr() if epilogue == "seeds" else None,
            walk if roots is None else first - k, b, party,
            eac._DPF_EPILOGUES.index(epilogue), *mask, *mod, arg,
            device=s0.device, kernel="dpf_eval_all" + tag)
        roots = dst


class Recorder:
    """Records each launch's kernel and arguments and each scratch tensor
    made while it is on (``torch.empty``)."""

    def __init__(self, monkeypatch):
        self.calls, self.scratch = [], []
        empty = torch.empty

        def recorded_empty(*args, **kwargs):
            x = empty(*args, **kwargs)
            self.scratch.append(x)
            return x

        def launch(source, fn, *args, device, kernel=None):
            self.calls.append((kernel, args))

        def launch_many(source, fn, calls, *, device, kernel=None):
            self.calls.extend((kernel, args) for args in calls)

        monkeypatch.setattr(_build, "function", lambda *a: None)
        monkeypatch.setattr(_build, "launch", launch)
        monkeypatch.setattr(_build, "launch_many", launch_many)
        self._patch = lambda on: monkeypatch.setattr(
            torch, "empty", recorded_empty if on else empty)

    def run(self, fn, *args):
        """(the launches, the scratch tensors) of ``fn(*args)``."""
        self.calls, self.scratch = [], []
        self._patch(True)
        try:
            fn(*args)
        finally:
            self._patch(False)
        return self.calls, self.scratch


def _named(calls, tensors):
    """Each launch with its addresses as (tensor name, byte offset) and
    its PRG argument as its bytes."""
    def name(x):
        if isinstance(x, ctypes._Pointer):
            return bytes(x.contents)
        if not isinstance(x, int) or isinstance(x, bool) or x < 1 << 16:
            return x
        for key, t in tensors:
            lo = t.data_ptr()
            if lo <= x < lo + t.numel() * t.element_size():
                return key, x - lo
        return "unknown", x
    return [(kernel, tuple(name(x) for x in args)) for kernel, args in calls]


def _key(in_bits, k=0):
    """KEYS keys' seeds [KEYS, 4] and wire rows [KEYS, n+1, 8], the
    shares [KEYS, 2^(n-k), 4] and the t bits [KEYS, 2^(n-k)]."""
    rng = np.random.default_rng(in_bits)
    s0 = torch.as_tensor(rng.integers(-2**31, 2**31, (KEYS, 4)),
                         dtype=torch.int32)
    cws = torch.as_tensor(rng.integers(-2**31, 2**31, (KEYS, in_bits + 1, 8)),
                          dtype=torch.int32)
    out = torch.empty((KEYS, 1 << (in_bits - k), 4), dtype=torch.int32)
    t = torch.empty((KEYS, 1 << (in_bits - k)), dtype=torch.int32)
    return s0, cws, out, t


@pytest.mark.parametrize("in_bits", BITS)
@pytest.mark.parametrize("prg", PRGS)
def test_one_key_launches_are_the_per_key_loops(in_bits, prg, monkeypatch):
    """One key, as ``eval_all`` and ``expand_leaves`` pass it."""
    rec, prg2, cases = Recorder(monkeypatch), PRGS[prg], 0
    for (most, shard), group, party, leaves in (
            (s, g, p, v) for s in SHARDS for g in GROUPS for p in (0, 1)
            for v in (False, True)):
        if shard[1].bit_length() - 1 >= in_bits or (
                leaves and group != GROUPS[0]):
            continue
        most, r, k = eac.shard_plan(in_bits, most, shard)
        s0, cws, out, t = _key(in_bits, k)
        g, bits = (None, t[0]) if leaves else (group, None)
        old, old_scratch = rec.run(
            _per_key_launches, prg2, g, in_bits, party, s0[0], cws[0], most,
            out[0], bits, r, k)
        new, new_scratch = rec.run(
            eac._dpf_launches, prg2, g, in_bits, party, s0[:1], cws[:1],
            most, out[:1], None if bits is None else t[:1], r, k)
        known = [("s0", s0), ("cws", cws), ("out", out), ("t", t)]
        assert len(old) == len(eac.plan(in_bits, most))
        assert _named(old, known + [("scratch", x) for x in old_scratch]) \
            == _named(new, known + [("scratch", x) for x in new_scratch]), \
            (most, shard, group, party, leaves)
        cases += 1
    assert cases >= 16


@pytest.mark.parametrize("in_bits", BITS)
@pytest.mark.parametrize("prg", PRGS)
def test_batch_launches_are_the_per_key_loops(in_bits, prg, monkeypatch):
    """A batch of KEYS keys, as ``eval_all_batch`` passes it: key i's
    launches, in the batch's order, are the per-key loop's of key i, its
    nodes in row i of the batch's scratch."""
    rec, prg2 = Recorder(monkeypatch), PRGS[prg]
    for group, party in ((g, p) for g in GROUPS for p in (0, 1)):
        s0, cws, out, _ = _key(in_bits)
        new, new_scratch = rec.run(
            eac._dpf_launches, prg2, group, in_bits, party, s0, cws,
            eac.SUBTREE_LEVELS, out)
        steps = len(eac.plan(in_bits))
        assert len(new) == KEYS * steps
        known = [("s0", s0), ("cws", cws), ("out", out)]
        for i in range(KEYS):
            old, old_scratch = rec.run(
                _per_key_launches, prg2, group, in_bits, party, s0[i],
                cws[i], eac.SUBTREE_LEVELS, out[i])
            assert _named(old, known + [("scratch", x) for x in old_scratch]) \
                == _named(new[i * steps:(i + 1) * steps],
                          known + [("scratch", x[i]) for x in new_scratch]), \
                (group, party, i)
