"""DPF, DCF, Half-Tree and VDPF full-domain evaluation (EvalAll) on the
card: wrappers of the CUDA kernels ``csrc/dpf_eval_all.cu``,
``csrc/dcf_eval_all.cu`` and ``csrc/ht_eval_all.cu``; the VDPF expands its
tree with the DPF's kernel and hashes and folds with the hash kernels.

Counterpart of ``fss_tpu.ops.eval_all_pallas``; the kernels replace
``eval_all_pallas._expand_packed``, ``eval_all_pallas.dcf_eval_all`` and
``eval_all_pallas.ht_eval_all`` with the ChaCha PRG, and with AES-128-MMO
they are the card's AES EvalAll, which the JAX package runs as XLA. Each
wrapper takes the scheme's PRG object (ChaCha or AesMmo). Nodes are packed
(s, t) [N, 4] int32 blocks with t in the clamped bit; a DCF node also
carries its raw value accumulator (``ops/dcf_cuda.py``); a Half-Tree node
is the whole 128-bit node, which holds t in the same bit.

Every scheme runs two launches a domain (one at in_bits = 1), at any
in_bits (:func:`plan`). The 2^n leaves are cut into 2^k subtrees of b =
:func:`subtree_levels` levels, k = n - b; the top launch expands the
first k levels and writes the 2^k subtree roots to a scratch buffer, and
each CTA of the body launch expands one subtree in shared memory and writes
its leaves' finished shares, the group finalize done in the kernel
(``csrc/subtree.cuh``), so no torch op runs over the leaves. The Half-Tree
counts its conversion level as one of its in_bits levels: the body's last
level makes both leaves of each node, so at in_bits = 1 the one launch is
the conversion alone. The DPF kernel's seeds epilogue writes the leaf seeds
and t bits instead (:func:`expand_leaves`), which the VDPF hashes. The
plain versions (:func:`eval_all_plain`, :func:`expand_leaves_plain`,
:func:`dcf_eval_all_plain`, :func:`ht_eval_all_plain`) follow the same
plan, ``most`` included: each launch's walks from the root (batched), then
its breadth-first levels. With ``shard`` = (r, 2^k) each returns only rank
r's leaves of 2^k (``parallel.mesh``'s domain axis): the top launch runs
whole and the body launch expands the shard's own roots
(:func:`shard_plan`); the kernels are the same.

CUDA tensors go to the kernel (a failing build or launch raises), CPU
tensors to the plain PyTorch versions.
"""

from __future__ import annotations

import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch.block import i32
from fss_tpu_torch.ops import dcf_cuda, ht_cuda, vdpf_cuda
from fss_tpu_torch.schemes import _tree
from fss_tpu_torch.schemes import dcf as _dcf
from fss_tpu_torch.schemes import dpf as _dpf
from fss_tpu_torch.schemes import half_tree_dpf as _ht
from fss_tpu_torch.schemes import vdpf as _vdpf

SUBTREE_LEVELS = 12  # fss::kMaxSubtreeLevels of csrc/subtree.cuh

_DPF_ARGS = (_build.P, _build.P, _build.P, _build.I64, _build.P, _build.P,
             *(_build.INT,) * 4, *(_build.U32,) * 8, _build.P, _build.P)
_DCF_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.I64, _build.P,
             _build.P, *(_build.INT,) * 4, *(_build.U32,) * 12, _build.P,
             _build.P)
_HT_ARGS = (_build.P, _build.P, _build.P, _build.I64, _build.P, _build.P,
            *(_build.INT,) * 4, *(_build.U32,) * 12, _build.P, _build.P)


# ---------------------------------------------------------------------------
# The plan: two launches a domain, one CTA a subtree
# ---------------------------------------------------------------------------

def subtree_levels(in_bits: int, most: int = SUBTREE_LEVELS) -> int:
    """The levels b each body CTA expands below its subtree root: half the
    domain's levels (rounded up), at most ``most``."""
    return min(most, (in_bits + 1) // 2)


def plan(in_bits: int, most: int = SUBTREE_LEVELS):
    """The launches of one EvalAll (``csrc/subtree.cuh``):
    [(first, walk, b)], a launch running tree levels first .. first + walk
    + b - 1, its CTAs each walking ``walk`` levels and expanding ``b``. At
    in_bits = 1 one launch; else the top launch, levels 0 .. k-1 with k =
    in_bits - subtree_levels(in_bits), split the same way (2^(k - t) CTAs
    walk k - t levels and expand t = subtree_levels(k)), and the body, 2^k
    CTAs of subtree_levels(in_bits) levels."""
    b = subtree_levels(in_bits, most)
    k = in_bits - b
    if k == 0:
        return [(0, 0, b)]
    top = subtree_levels(k, most)
    return [(0, k - top, top), (k, 0, b)]


def shard_plan(in_bits: int, most: int, shard):
    """The plan of one shard of a domain: (most, r, k) for ``shard`` =
    (r, 2^k), rank r's leaves [r 2^(n-k), (r+1) 2^(n-k)). ``most`` is
    capped at n - k so that the top launch makes at least 2^k roots; the
    shard's body launch then expands roots [r 2^(K-k), (r+1) 2^(K-k)) of
    the 2^K, the top launch running whole on every rank (its roots are a
    few hundred KB at most). Needs k < in_bits."""
    r, count = shard
    k = count.bit_length() - 1
    if count != 1 << k or not 0 <= r < count:
        raise ValueError(f"shard must be (r, 2^k) with 0 <= r < 2^k, got "
                         f"{shard}")
    if k >= in_bits:
        raise ValueError(f"{count} shards need in_bits > {k}, got "
                         f"{in_bits}")
    return min(most, in_bits - k), r, k


def _shard_rows(first: int, r: int, k: int, *xs):
    """Shard r of 2^k of each level-``first`` tensor: its rows
    [r 2^(first-k), (r+1) 2^(first-k)) (views)."""
    w = first - k
    return tuple(x[r << w:(r + 1) << w] for x in xs)


def _check_key(s0, cws, in_bits, party, rows, words, most):
    if in_bits < 1:
        raise ValueError(f"EvalAll needs in_bits >= 1, got {in_bits}")
    if party not in (0, 1):
        raise ValueError(f"party must be 0 or 1, got {party}")
    if not 1 <= most <= SUBTREE_LEVELS:
        raise ValueError(f"most must be in 1..{SUBTREE_LEVELS}, got {most}")
    dev = s0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _build.check(s0, "s0", dev, [(4,)])
    if cws.dim() != 2 or cws.shape[0] < rows or cws.shape[1] < words:
        raise ValueError(f"cws must be [>={rows}, >={words}], got "
                         f"{tuple(cws.shape)}")
    if cws.device != dev or cws.dtype != torch.int32:
        raise ValueError("cws must be int32 on s0's device")
    if cws.stride(1) != 1:
        raise ValueError("cws words must be contiguous")
    return dev


def _walk_bits(walk: int, device) -> torch.Tensor:
    """The path bits [2^walk, walk] (MSB first) from the root to each node
    of level ``walk``, in x order."""
    q = torch.arange(1 << walk, dtype=torch.int32, device=device)
    return blk.input_bits_msb_first(q[:, None], walk)


def _rows(cws: torch.Tensor, first: int) -> int:
    """The device address of cw row ``first``."""
    return cws.data_ptr() + first * cws.stride(0) * cws.element_size()


# ---------------------------------------------------------------------------
# DPF
# ---------------------------------------------------------------------------

# The DPF kernel's epilogues: the shares of a group kind, the seeds and t
# bits, or packed nodes for the next launch (csrc/dpf_eval_all.cu).
_DPF_EPILOGUES = (*dcf_cuda.MODES, "seeds", "nodes")


def _dpf_launches(prg2, group, in_bits, party, s0, cws, most, out, t=None,
                  r=0, k=0):
    """The plan's launches of each key of s0 [Q, 4] and cws [Q, rows,
    words] into ``out`` [Q, 2^(n-k), 4] (shares, or with ``t`` [Q,
    2^(n-k)] the seeds and t bits), shard r of 2^k; the top launches'
    roots go to a scratch buffer. The launches are made in one call
    (``_build.launch_many``), so that the host's cost a key is its
    launch calls."""
    arg, tag = _build.prg_arg(prg2, 2)
    fn = _build.function("dpf_eval_all", "fss_dpf_eval_all", _DPF_ARGS)
    steps = plan(in_bits, most)
    top = sum(steps[0])  # the top launch's last level, the body's roots
    nodes = None if len(steps) == 1 else torch.empty(
        (s0.shape[0], 1 << top, 4), dtype=torch.int32, device=s0.device)
    epilogue = "seeds" if t is not None else dcf_cuda.group_mode(group)
    mask, mod = (dcf_cuda.gen_params(group) if epilogue in dcf_cuda.MODES
                 else ((0,) * 4,) * 2)
    leaves = (_DPF_EPILOGUES.index(epilogue), *mask, *mod)
    roots_of = (_DPF_EPILOGUES.index("nodes"), *(0,) * 8)

    def at(x):  # i, row -> the device address of x[i, row] (int32 words)
        base, (step, row_step) = x.data_ptr(), x.stride()[:2]
        return lambda i, row=0: base + (i * step + row * row_step) * 4

    seed, rows, leaf = at(s0), at(cws), at(out)
    node, bit = (None if x is None else at(x) for x in (nodes, t))
    calls = []
    for i in range(s0.shape[0]):
        roots = None  # the previous launch's nodes, level ``first``
        for first, walk, b in steps:
            if first + walk + b < in_bits:
                dst, seeds, tail = node(i), None, roots_of
            else:
                dst, tail = leaf(i), leaves
                seeds = None if bit is None else bit(i)
            calls.append((seed(i), None if roots is None else
                          roots + (r << (first - k)) * 16,  # the shard's
                          rows(i, first), cws.stride(1), dst, seeds,
                          walk if roots is None else first - k, b, party,
                          *tail, arg))
            roots = dst
    _build.launch_many("dpf_eval_all", fn, calls, device=s0.device,
                       kernel="dpf_eval_all" + tag)


def eval_all(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
             cws: torch.Tensor, most: int = SUBTREE_LEVELS,
             shard=(0, 1)) -> torch.Tensor:
    """Full-domain DPF evaluation of one key: [2^in_bits, 4] shares in x
    order, for every group. ``prg2`` is the scheme's mul=2 PRG (ChaCha or
    AesMmo); s0 the party's seed [4]; cws its wire rows [in_bits+1, 8].
    The :func:`plan`'s launches of ``csrc/dpf_eval_all.cu`` (``most``: its
    cap on :func:`subtree_levels`). ``shard`` = (r, 2^k): only leaves
    [r 2^(n-k), (r+1) 2^(n-k)), [2^(n-k), 4] (:func:`shard_plan`)."""
    dev = _check_key(s0, cws, in_bits, party, in_bits + 1, 5, most)
    _build.check_prg(prg2, 2)
    if dev.type == "cpu":
        return eval_all_plain(prg2, group, in_bits, party, s0, cws, most,
                              shard)
    most, r, k = shard_plan(in_bits, most, shard)
    out = torch.empty((1 << (in_bits - k), 4), dtype=torch.int32,
                      device=dev)
    _dpf_launches(prg2, group, in_bits, party, s0[None], cws[None], most,
                  out[None], r=r, k=k)
    return out


def eval_all_batch(prg2, group, in_bits: int, party: int, s0: torch.Tensor,
                   cws: torch.Tensor) -> torch.Tensor:
    """Full-domain DPF evaluation of a batch of keys: [Q, 2^in_bits, 4],
    key q's shares as :func:`eval_all` gives them, by the same launches
    (the :func:`plan`'s two a key, one at in_bits = 1). s0 [Q, 4] the
    party's seeds; cws [Q, in_bits+1, 8] its wire rows. The checks, the
    PRG's argument and the top launches' roots are made once for the
    batch, and all its launches in one call."""
    if s0.dim() != 2 or s0.shape[0] < 1 or cws.dim() != 3 or \
            cws.shape[0] != s0.shape[0]:
        raise ValueError(f"s0 must be [Q, 4] and cws [Q, ...] with Q >= 1, "
                         f"got {tuple(s0.shape)} and {tuple(cws.shape)}")
    dev = _check_key(s0[0], cws[0], in_bits, party, in_bits + 1, 5,
                     SUBTREE_LEVELS)
    _build.check(s0, "s0", dev, [tuple(s0.shape)])
    _build.check_prg(prg2, 2)
    if dev.type == "cpu":
        return torch.stack([eval_all_plain(prg2, group, in_bits, party, s0[i],
                                           cws[i])
                            for i in range(s0.shape[0])])
    out = torch.empty((s0.shape[0], 1 << in_bits, 4), dtype=torch.int32,
                      device=dev)
    _dpf_launches(prg2, group, in_bits, party, s0, cws, SUBTREE_LEVELS, out)
    return out


def expand_leaves(prg2, in_bits: int, party: int, s0: torch.Tensor,
                  cws: torch.Tensor, most: int = SUBTREE_LEVELS,
                  shard=(0, 1)):
    """Expand one key to its leaf layer: (seeds [2^n, 4] with the clamped
    bit clear, t [2^n]) in x order, the kernel's seeds epilogue; cws are
    rows [>=in_bits, >=5] (the VDPF's have no output row). ``shard`` as
    for :func:`eval_all`."""
    dev = _check_key(s0, cws, in_bits, party, in_bits, 5, most)
    _build.check_prg(prg2, 2)
    if dev.type == "cpu":
        return expand_leaves_plain(prg2, in_bits, party, s0, cws, most,
                                   shard)
    most, r, k = shard_plan(in_bits, most, shard)
    out = torch.empty((1 << (in_bits - k), 4), dtype=torch.int32,
                      device=dev)
    t = torch.empty((1 << (in_bits - k),), dtype=torch.int32, device=dev)
    _dpf_launches(prg2, None, in_bits, party, s0[None], cws[None], most,
                  out[None], t[None], r, k)
    return out, t


def expand_leaves_plain(prg2, in_bits: int, party: int, s0, cws,
                        most: int = SUBTREE_LEVELS, shard=(0, 1)):
    """Plain PyTorch version of :func:`expand_leaves`, on any device, on
    the kernel's plan: each launch's walks from the root, then its
    breadth-first levels (a shard's body from its own roots)."""
    _check_key(s0, cws, in_bits, party, in_bits, 5, most)
    _build.check_prg(prg2, 2)
    most, r, k = shard_plan(in_bits, most, shard)
    s = t = None
    for first, walk, b in plan(in_bits, most):
        if s is None:
            bits = _walk_bits(walk, s0.device)
            B = bits.shape[0]
            s, t = _dpf.walk(prg2, walk, party, s0.expand(B, 4),
                             lambda i: cws[i].expand(B, cws.shape[1]), bits)
        else:
            s, t = _shard_rows(first, r, k, s, t)
        for i in range(first + walk, first + walk + b):
            s, t = _tree.expand_level(prg2, s, t,
                                      *_tree.unpack_cw_row(cws[i]))
    return s, t


def eval_all_plain(prg2, group, in_bits: int, party: int, s0, cws,
                   most: int = SUBTREE_LEVELS, shard=(0, 1)) -> torch.Tensor:
    """Plain PyTorch version of :func:`eval_all`, on any device."""
    _check_key(s0, cws, in_bits, party, in_bits + 1, 5, most)
    s, t = expand_leaves_plain(prg2, in_bits, party, s0, cws, most, shard)
    return _dpf.finalize_leaves(group, party, s, t, cws[in_bits, 0:4])


# ---------------------------------------------------------------------------
# DCF
# ---------------------------------------------------------------------------

def dcf_eval_all(prg4, group, in_bits: int, party: int, s0: torch.Tensor,
                 cws: torch.Tensor, most: int = SUBTREE_LEVELS,
                 shard=(0, 1)) -> torch.Tensor:
    """Full-domain DCF evaluation of one key: [2^in_bits, 4] shares in x
    order, for every group. ``prg4`` is the scheme's mul=4 PRG (ChaCha or
    AesMmo); s0 the party's seed [4]; cws its wire rows [in_bits+1, 8].
    The :func:`plan`'s launches of ``csrc/dcf_eval_all.cu``; the top
    launch's roots and their accumulators go to scratch buffers.
    ``shard`` as for :func:`eval_all` (the shard's roots and their
    accumulators alike)."""
    dev = _check_key(s0, cws, in_bits, party, in_bits + 1, 8, most)
    arg, tag = _build.prg_arg(prg4, 4)
    if dev.type == "cpu":
        return dcf_eval_all_plain(prg4, group, in_bits, party, s0, cws, most,
                                  shard)
    most, r, k = shard_plan(in_bits, most, shard)
    mode = dcf_cuda.group_mode(group)
    mask, mod = dcf_cuda.gen_params(group)
    vmask = [int(m) & blk.MASK32 for m in dcf_cuda.value_mask(group)]
    fn = _build.function("dcf_eval_all", "fss_dcf_eval_all", _DCF_ARGS)
    roots = acc = None
    for first, walk, b in plan(in_bits, most):
        if roots is not None:
            roots, acc = _shard_rows(first, r, k, roots, acc)
        last = first + walk + b == in_bits
        # the nodes of the launch's last level
        n = 1 << (first + walk + b - (k if last else 0))
        out = torch.empty((n, 4), dtype=torch.int32, device=dev)
        acc_out = None if last else torch.empty(
            (n, dcf_cuda.acc_words(mode)), dtype=torch.int32, device=dev)
        _build.launch(
            "dcf_eval_all", fn, s0.data_ptr(),
            None if roots is None else roots.data_ptr(),
            None if acc is None else acc.data_ptr(), _rows(cws, first),
            cws.stride(0), out.data_ptr(),
            None if acc_out is None else acc_out.data_ptr(),
            walk if roots is None else first - k, b, party,
            dcf_cuda.MODES.index(mode), *vmask, *mask, *mod, arg, device=dev,
            kernel="dcf_eval_all" + tag)
        roots, acc = out, acc_out
    return roots


def dcf_eval_all_plain(prg4, group, in_bits: int, party: int, s0, cws,
                       most: int = SUBTREE_LEVELS,
                       shard=(0, 1)) -> torch.Tensor:
    """Plain PyTorch version of :func:`dcf_eval_all`, on any device, on the
    kernel's plan: each launch's walks from the root (with the raw
    accumulators), then its breadth-first levels, then the finalize."""
    _check_key(s0, cws, in_bits, party, in_bits + 1, 8, most)
    _build.check_prg(prg4, 4)
    most, r, k = shard_plan(in_bits, most, shard)
    mode = dcf_cuda.group_mode(group)
    add = dcf_cuda.accumulator(mode, dcf_cuda.value_mask(group))
    s = t = v = None
    for first, walk, b in plan(in_bits, most):
        if s is None:
            bits = _walk_bits(walk, s0.device)
            B = bits.shape[0]
            acc = torch.zeros((B, dcf_cuda.acc_words(mode)),
                              dtype=torch.int64, device=s0.device)
            s, t, v = _dcf.walk(prg4, walk, party, s0.expand(B, 4),
                                lambda i: cws[i].expand(B, cws.shape[1]),
                                bits, acc, add)
        else:
            s, t, v = _shard_rows(first, r, k, s, t, v)
        for i in range(first + walk, first + walk + b):
            s, t, v = _dcf.expand_level(prg4, s, t, v, cws[i], add)
    return dcf_cuda.finalize(group, party, i32(v), s, t, cws[in_bits, 4:8])


# ---------------------------------------------------------------------------
# Half-Tree
# ---------------------------------------------------------------------------

# The Half-Tree kernel's epilogues: the shares of a group kind, or nodes for
# the next launch (csrc/ht_eval_all.cu).
_HT_EPILOGUES = (*dcf_cuda.MODES, "nodes")


def _check_ht(prg1, in_bits, party, s0, cws, ocw, most):
    dev = _check_key(s0, cws, in_bits, party, in_bits, 5, most)
    _build.check(ocw, "ocw", dev, [(4,)])
    _build.check_prg(prg1, 1)
    return dev


def ht_eval_all(prg1, group, in_bits: int, party: int, hash_key,
                s0: torch.Tensor, cws: torch.Tensor, ocw: torch.Tensor,
                most: int = SUBTREE_LEVELS, shard=(0, 1)) -> torch.Tensor:
    """Full-domain Half-Tree evaluation of one key: [2^in_bits, 4] shares
    in x order, for every group. ``prg1`` is the scheme's mul=1 PRG (ChaCha
    or AesMmo); hash_key the CCR hash key (4 words); s0 the party's seed
    [4]; cws its key rows [in_bits, >=5] (the last the conversion's); ocw
    its output CW [4]. The :func:`plan`'s launches of
    ``csrc/ht_eval_all.cu`` (``most``: its cap on :func:`subtree_levels`);
    the body's last level is the conversion, then the finalize. ``shard``
    as for :func:`eval_all`."""
    dev = _check_ht(prg1, in_bits, party, s0, cws, ocw, most)
    hk = ht_cuda.hash_words(hash_key)
    if dev.type == "cpu":
        return ht_eval_all_plain(prg1, group, in_bits, party, hk, s0, cws,
                                 ocw, most, shard)
    most, r, k = shard_plan(in_bits, most, shard)
    arg, tag = _build.prg_arg(prg1, 1)
    mask, mod = dcf_cuda.gen_params(group)
    fn = _build.function("ht_eval_all", "fss_ht_eval_all", _HT_ARGS)
    out = torch.empty((1 << (in_bits - k), 4), dtype=torch.int32,
                      device=dev)
    roots = None
    for first, walk, b in plan(in_bits, most):
        if roots is not None:
            roots, = _shard_rows(first, r, k, roots)
        last = first + walk + b == in_bits
        dst = out if last else torch.empty(
            (1 << (first + walk + b), 4), dtype=torch.int32, device=dev)
        epilogue = dcf_cuda.group_mode(group) if last else "nodes"
        _build.launch(
            "ht_eval_all", fn, s0.data_ptr(),
            None if roots is None else roots.data_ptr(), _rows(cws, first),
            cws.stride(0), dst.data_ptr(), ocw.data_ptr(),
            walk if roots is None else first - k, b, party,
            _HT_EPILOGUES.index(epilogue), *hk, *mask, *mod, arg,
            device=dev, kernel="ht_eval_all" + tag)
        roots = dst
    return out


def ht_eval_all_plain(prg1, group, in_bits: int, party: int, hash_key,
                      s0, cws, ocw, most: int = SUBTREE_LEVELS,
                      shard=(0, 1)):
    """Plain PyTorch version of :func:`ht_eval_all`, on any device, on the
    kernel's plan: each launch's walks from the root, then its
    breadth-first levels, the conversion last, then the finalize."""
    _check_ht(prg1, in_bits, party, s0, cws, ocw, most)
    most, r, k = shard_plan(in_bits, most, shard)
    hk = ht_cuda.hash_block(hash_key, s0.device)
    nodes = None
    for first, walk, b in plan(in_bits, most):
        if nodes is None:
            bits = _walk_bits(walk, s0.device)
            B = bits.shape[0]
            # walk + 1 domain bits: the point walk's `walk` hash levels
            nodes = _ht.walk(prg1, walk + 1, party, hk, s0.expand(B, 4),
                             lambda i: cws[i, 0:4].expand(B, 4), bits)
        else:
            nodes, = _shard_rows(first, r, k, nodes)
        for i in range(first + walk, first + walk + b):
            if i == in_bits - 1:
                high, low = _ht.convert_both(prg1, hk, nodes, cws[i])
            else:
                nodes = _ht.expand_level(prg1, hk, nodes, cws[i, 0:4])
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
    EvalAll kernel with its seeds epilogue (:func:`expand_leaves`), the
    DPF's finalize, pi~ of the whole domain through the XorHash kernel (x
    as lane 0), the t ? cs : 0 correction in place, and ``fold``:
    "reference" (the flat chain kernel), "tree" (one H' launch a
    level) or "chunked". Both parties must use the same fold. cws are VDPF
    rows [in_bits, 8].
    """
    s, t = expand_leaves(prg2, in_bits, party, s0, cws)
    return _vdpf.leaf_outputs(
        lambda a, b: vdpf_cuda.xor_hash(hashes, a, b),
        lambda pts, c: vdpf_cuda.fold(hashes, pts, c, fold), group, party,
        s, t, cs, ocw)
