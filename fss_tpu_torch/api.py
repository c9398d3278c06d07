"""High-level FSS API on PyTorch tensors.

Counterpart of ``fss_tpu.api`` for its six schemes (``Dpf``,
``PackedDpfKeys``, ``Dcf``, ``HalfTreeDpf``, ``GrottoDcf``, ``Vdpf``,
``Vdmpf``, ``DEFAULT_NONCE``, ``DEFAULT_HASH_IV``), each with the ChaCha
PRG (the default) or AES-128-MMO (``prg.aes.AesMmo``).
Entry points run on the card unless the caller asks for the CPU:
``device="cuda"`` is the default, and inputs given as ints, lists, numpy
arrays or tensors are moved to the scheme's ``device``. On a CUDA device
every Gen, Eval and EvalAll goes through the CUDA kernels of
``fss_tpu_torch.ops``, for every group and every ``in_bits`` in 1..128; on
the CPU through their plain PyTorch versions. There is no fallback
between the two.

Keys and shares are int32 tensors bit-identical to the reference's int32
tensors and to the JAX package's uint32 arrays.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.hash import Blake3
from fss_tpu_torch.ops import (dcf_cuda, dpf_cuda, eval_all_cuda, ht_cuda,
                               vdpf_cuda)
from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.prp.feistel import ceil_log2
from fss_tpu_torch.schemes import cuckoo as _cuckoo
from fss_tpu_torch.schemes import grotto_dcf as _grotto
from fss_tpu_torch.schemes import vdmpf as _vdmpf
from fss_tpu_torch.schemes import vdpf as _vdpf
from fss_tpu_torch.utils.profiling import span

DEFAULT_NONCE = (0x243F6A88, 0x85A308D3)  # pi digits; nothing up my sleeve
DEFAULT_HASH_IV = (0x11111111, 0x22222222, 0x33333333, 0x44444444,
                   0x55555555, 0x66666666, 0x77777777, 0x88888888)


class PackedDpfKeys(typing.NamedTuple):
    """A DPF key batch in the kernels' packed layout.

    ``Dpf.gen_batch(..., layout="packed")`` returns this instead of wire
    rows [B, in_bits+1, 8]; ``Dpf.eval`` accepts it wherever wire keys
    go. The layout holds only the 5 cw words each level uses, as planes
    in which neighbouring keys sit on neighbouring words. It is for
    same-process gen -> eval pipelines; keys that leave the process need
    the wire layout (``to_wire``).

    Fields: cws_p [in_bits, 5, B] int32 cw planes; ocw [B, 4] int32
    output CW.
    """

    cws_p: torch.Tensor
    ocw: torch.Tensor

    @property
    def batch(self) -> int:
        return self.ocw.shape[0]

    def to_wire(self, in_bits: int) -> torch.Tensor:
        return dpf_cuda.wire_rows(in_bits, self.cws_p, self.ocw)

    @classmethod
    def from_wire(cls, cws: torch.Tensor, in_bits: int) -> "PackedDpfKeys":
        return cls(*dpf_cuda.pack_keys(cws, in_bits))


class _TreeScheme:
    """What the schemes share: the domain, group, PRG (ChaCha or
    AES-128-MMO) with ``MUL`` outputs, device, and the staging of
    inputs."""

    MUL = 0

    def __init__(self, in_bits: int, group=None, prg=None, device="cuda"):
        if not 1 <= in_bits <= 128:
            raise ValueError(f"in_bits must be in 1..128, got {in_bits}")
        self.in_bits = in_bits
        self.group = group if group is not None else groups.Bytes()
        self.prg = prg if prg is not None else ChaCha(mul=self.MUL,
                                                      nonce=DEFAULT_NONCE)
        if (not isinstance(self.prg, (ChaCha, AesMmo))
                or self.prg.mul != self.MUL):
            raise ValueError(f"{type(self).__name__} needs the ChaCha or "
                             f"AES-MMO PRG with mul={self.MUL}")
        self.device = torch.device(device)

    # -- input staging ----------------------------------------------------

    def _blocks(self, vals) -> torch.Tensor:
        return blk.block(vals, self.device).contiguous()

    def _inputs(self, xs) -> torch.Tensor:
        """Inputs in the kernels' layout: [B] words for in_bits <= 32 given
        as a flat int array, else [B, 4] lanes."""
        if self.in_bits <= 32 and not isinstance(xs, (int, np.integer)):
            arr = xs if isinstance(xs, torch.Tensor) else np.asarray(xs)
            if arr.ndim == 1:
                return blk.words(arr, self.device).contiguous()
        lanes = blk.pack_inputs(xs, self.in_bits, self.device)
        return lanes.reshape(-1, 4).contiguous()

    def _one(self, s0s, alpha, beta):
        """One key's Gen inputs as a batch of one for ``gen_batch``."""
        alpha = blk.pack_inputs(alpha, self.in_bits,
                                self.device).reshape(1, 4)
        return self._blocks(s0s)[None], alpha, self._blocks(beta)[None]

    def gen(self, s0s, alpha, beta) -> torch.Tensor:
        """One key: s0s [2, 4], alpha an int (or lanes), beta [4].
        Returns cws [in_bits+1, 8] through ``gen_batch``."""
        return self.gen_batch(*self._one(s0s, alpha, beta))[0]


class Dpf(_TreeScheme):
    """2-party DPF with the ChaCha or AES-MMO PRG (mul=2).

    Keys: cws (in_bits+1, 8) int32, the reference's wire layout.
    """

    MUL = 2

    # -- scheme -------------------------------------------------------------

    @span("api.Dpf.gen_batch")
    def gen_batch(self, s0s, alphas, betas, layout: str = "wire"):
        """Batched Gen through the gen kernel: s0s [B, 2, 4], alphas [B]
        (or [B, 4] lanes, or a list of ints), betas [B, 4].

        ``layout="wire"`` returns cws [B, in_bits+1, 8];
        ``layout="packed"`` returns :class:`PackedDpfKeys`.
        """
        args = (self.prg, self.group, self.in_bits, self._blocks(s0s),
                self._inputs(alphas), self._blocks(betas))
        if layout == "packed":
            return PackedDpfKeys(*dpf_cuda.gen_batch_packed(*args))
        if layout != "wire":
            raise ValueError(f"layout must be 'wire' or 'packed', got "
                             f"{layout}")
        return dpf_cuda.gen_batch(*args)

    @span("api.Dpf.eval")
    def eval(self, party: int, s0, cws, xs) -> torch.Tensor:
        """Point evaluation. s0 [B, 4] or [4]; cws wire rows
        [B, in_bits+1, 8], one key [in_bits+1, 8], or PackedDpfKeys; xs
        ints, an int array, or [B, 4] lanes. Returns [B, 4] shares ([4]
        for a single int x)."""
        x = self._inputs(xs)
        s0 = self._blocks(s0)
        if isinstance(cws, PackedDpfKeys):
            y = dpf_cuda.eval_points_packedkey(
                self.prg, self.group, self.in_bits, int(party), s0,
                self._blocks(cws.cws_p), self._blocks(cws.ocw), x)
        else:
            y = dpf_cuda.eval_points(self.prg, self.group, self.in_bits,
                                     int(party), s0, self._blocks(cws), x)
        return y[0] if isinstance(xs, (int, np.integer)) else y

    def eval_all(self, party: int, s0, cws) -> torch.Tensor:
        """Full-domain evaluation of one key: [2^in_bits, 4] shares."""
        return eval_all_cuda.eval_all(self.prg, self.group, self.in_bits,
                                      int(party), self._blocks(s0),
                                      self._blocks(cws))


class Dcf(_TreeScheme):
    """2-party DCF with the ChaCha or AES-MMO PRG (mul=4): y0 + y1 = beta where
    x < alpha (``pred="lt"``) or x > alpha (``pred="gt"``), else 0.

    Keys: cws (in_bits+1, 8) int32, the reference's wire layout.
    """

    MUL = 4

    def __init__(self, in_bits: int, group=None, prg=None, pred: str = "lt",
                 device="cuda"):
        super().__init__(in_bits, group, prg, device)
        if pred not in ("lt", "gt"):
            raise ValueError(f"pred must be 'lt' or 'gt', got {pred!r}")
        self.pred = pred

    @span("api.Dcf.gen_batch")
    def gen_batch(self, s0s, alphas, betas) -> torch.Tensor:
        """Batched Gen through the gen kernel: s0s [B, 2, 4], alphas [B]
        (or [B, 4] lanes, or a list of ints), betas [B, 4]. Returns wire
        rows cws [B, in_bits+1, 8]."""
        return dcf_cuda.gen_batch(self.prg, self.group, self.in_bits,
                                  self.pred, self._blocks(s0s),
                                  self._inputs(alphas), self._blocks(betas))

    @span("api.Dcf.eval")
    def eval(self, party: int, s0, cws, xs) -> torch.Tensor:
        """Point evaluation. s0 [B, 4] or [4]; cws wire rows
        [B, in_bits+1, 8] or one key [in_bits+1, 8]; xs ints, an int
        array, or [B, 4] lanes. Returns [B, 4] shares ([4] for a single int
        x)."""
        y = dcf_cuda.eval_points(self.prg, self.group, self.in_bits,
                                 int(party), self._blocks(s0),
                                 self._blocks(cws), self._inputs(xs))
        return y[0] if isinstance(xs, (int, np.integer)) else y

    def eval_all(self, party: int, s0, cws) -> torch.Tensor:
        """Full-domain evaluation of one key: [2^in_bits, 4] shares."""
        return eval_all_cuda.dcf_eval_all(self.prg, self.group, self.in_bits,
                                          int(party), self._blocks(s0),
                                          self._blocks(cws))


class HalfTreeDpf(_TreeScheme):
    """2-party Half-Tree DPF with the ChaCha or AES-MMO PRG (mul=1) as its
    CCR hash H(hash_key ^ node).

    Keys: (cws (in_bits, 8) int32, ocw (4,) int32), the reference's
    layout. ``hash_key`` is the public CCR-hash tweak, 4 words shared by
    both parties (zeros unless given).
    """

    MUL = 1

    def __init__(self, in_bits: int, group=None, prg=None, hash_key=None,
                 device="cuda"):
        super().__init__(in_bits, group, prg, device)
        self.hash_key = ht_cuda.hash_words(
            (0, 0, 0, 0) if hash_key is None else hash_key)

    def gen(self, s0s, alpha, beta):
        """One key: s0s [2, 4], alpha an int (or lanes), beta [4].
        Returns (cws [in_bits, 8], ocw [4]) through ``gen_batch``."""
        cws, ocw = self.gen_batch(*self._one(s0s, alpha, beta))
        return cws[0], ocw[0]

    def gen_batch(self, s0s, alphas, betas):
        """Batched Gen through the gen kernel: s0s [B, 2, 4], alphas [B]
        (or [B, 4] lanes, or a list of ints), betas [B, 4]. Returns
        (cws [B, in_bits, 8], ocw [B, 4])."""
        return ht_cuda.gen_batch(self.prg, self.group, self.in_bits,
                                 self.hash_key, self._blocks(s0s),
                                 self._inputs(alphas), self._blocks(betas))

    def eval(self, party: int, s0, cws, ocw, xs) -> torch.Tensor:
        """Point evaluation. s0 [B, 4] or [4]; cws [B, in_bits, 8] or one
        key [in_bits, 8]; ocw [B, 4] or [4]; xs ints, an int array, or
        [B, 4] lanes. Returns [B, 4] shares ([4] for a single int x)."""
        y = ht_cuda.eval_points(self.prg, self.group, self.in_bits,
                                int(party), self.hash_key, self._blocks(s0),
                                self._blocks(cws), self._blocks(ocw),
                                self._inputs(xs))
        return y[0] if isinstance(xs, (int, np.integer)) else y

    def eval_all(self, party: int, s0, cws, ocw) -> torch.Tensor:
        """Full-domain evaluation of one key: [2^in_bits, 4] shares."""
        return eval_all_cuda.ht_eval_all(self.prg, self.group, self.in_bits,
                                         int(party), self.hash_key,
                                         self._blocks(s0), self._blocks(cws),
                                         self._blocks(ocw))


class Vdpf(_TreeScheme):
    """Verifiable DPF with the ChaCha or AES-MMO PRG (mul=2) and a keyed
    hash.

    Keys: (cws (in_bits, 8), cs (4, 4), ocw (4,)) int32, the reference's
    layout. ``gen`` returns the reference's ``fail`` flag (the parties'
    final control bits equal), and ``gen_retry`` and ``gen_batch`` draw
    new seeds until no key fails; as the level loop keeps t0 ^ t1 = 1 on
    the path to alpha, honest seeds never fail. Eval returns the
    share and the corrected per-point hash pi~; ``prove`` folds pi~s into
    one proof; ``verify`` compares two proofs.
    """

    MUL = 2

    def __init__(self, in_bits: int, group=None, prg=None, hash_iv=None,
                 hashes=None, device="cuda"):
        """``hashes``: ``hash.Blake3`` or ``hash.Sha256`` (H and H' of the
        scheme); by default Blake3 keyed with ``hash_iv`` (or
        DEFAULT_HASH_IV). On the CPU any object with the same
        ``xor_hash``/``hash64`` methods on int32 tensors also works."""
        super().__init__(in_bits, group, prg, device)
        if hashes is None:
            hashes = Blake3(DEFAULT_HASH_IV if hash_iv is None else hash_iv)
        vdpf_cuda.hash_kind(hashes, self.device)  # others: the CPU only
        self.hashes = hashes
        self._prp = None  # the PRP of the last key evaluated

    def _key_prp(self, key: _vdmpf.VdmpfKey):
        """The key's PRP: kept from the last call while sigma is the
        same (both parties' keys share it), else made anew."""
        if self._prp is None or self._prp.sigma != bytes(key.sigma):
            self._prp = _vdmpf.key_prp(key, self.in_bits, self.kappa)
        return self._prp

    def _gen_keys(self, s0s, alphas, betas):
        return vdpf_cuda.gen_batch(self.prg, self.hashes, self.group,
                                   self.in_bits, s0s, alphas, betas)

    def gen(self, s0s, alpha, beta):
        """One key: s0s [2, 4], alpha an int (or lanes), beta [4]. Returns
        (cws [in_bits, 8], cs [4, 4], ocw [4], fail): where fail is 1 the
        caller must draw new seeds."""
        return tuple(x[0] for x in self._gen_keys(*self._one(s0s, alpha,
                                                             beta)))

    def gen_retry(self, rng, alpha, beta, max_tries: int = 64):
        """Draw seeds [2, 4] from the numpy Generator ``rng`` and run Gen
        until it succeeds. Returns (s0s, cws, cs, ocw)."""
        for _ in range(max_tries):
            s0s = self._blocks(rng.integers(0, 2**32, size=(2, 4)))
            cws, cs, ocw, fail = self.gen(s0s, alpha, beta)
            if not int(fail):
                return s0s, cws, cs, ocw
        raise RuntimeError("vdpf gen retry budget exhausted")

    def gen_batch(self, rng, alphas, betas, max_rounds: int = 64):
        """Batched Gen with per-key retry: alphas [B] (or [B, 4] lanes, or
        a list of ints), betas [B, 4]; seeds drawn from the numpy
        Generator ``rng``.

        The JAX package's loop exactly, so the same ``rng`` gives the
        same bytes: Gen of the whole batch, then each round draws fresh
        seeds for the whole batch, runs Gen on all of it, and keeps the
        new keys of the lanes that failed before and succeed now. The
        draws stay on the host and the seeds move to the card each round;
        the scatter and the fail mask stay on the card, with one host
        sync a round. Returns (s0s [B, 2, 4], cws [B, in_bits, 8], cs
        [B, 4, 4], ocw [B, 4]).
        """
        a, b = self._inputs(alphas), self._blocks(betas)
        size = (a.shape[0], 2, 4)
        s0s = self._blocks(rng.integers(0, 2**32, size=size))
        cws, cs, ocw, fail = self._gen_keys(s0s, a, b)
        fail = fail.bool()
        for _ in range(max_rounds):
            if not bool(fail.any()):
                return s0s, cws, cs, ocw
            new = self._blocks(rng.integers(0, 2**32, size=size))
            ncws, ncs, nocw, nfail = self._gen_keys(new, a, b)
            take = fail & ~nfail.bool()
            s0s = torch.where(take[:, None, None], new, s0s)
            cws = torch.where(take[:, None, None], ncws, cws)
            cs = torch.where(take[:, None, None], ncs, cs)
            ocw = torch.where(take[:, None], nocw, ocw)
            fail &= ~take
        raise RuntimeError("vdpf gen_batch retry budget exhausted")

    def eval(self, party: int, s0, cws, cs, ocw, xs):
        """Point evaluation. s0 [B, 4] or [4]; cws [B, in_bits, 8] or one
        key [in_bits, 8]; cs [B, 4, 4] or [4, 4]; ocw [B, 4] or [4]; xs
        ints, an int array, or [B, 4] lanes. Returns (ys [B, 4], pi_tildes
        [B, 4, 4]), or ([4], [4, 4]) for a single int x."""
        ys, pi = vdpf_cuda.eval_points(
            self.prg, self.hashes, self.group, self.in_bits, int(party),
            self._blocks(s0), self._blocks(cws), self._blocks(cs),
            self._blocks(ocw), self._inputs(xs))
        if isinstance(xs, (int, np.integer)):
            return ys[0], pi[0]
        return ys, pi

    def prove(self, pi_tildes, cs) -> torch.Tensor:
        """The reference's flat fold of pi_tildes [N, 4, 4] from cs
        [4, 4]: [4, 4]."""
        return vdpf_cuda.prove(self.hashes, self._blocks(pi_tildes),
                               self._blocks(cs))

    @staticmethod
    def verify(pi0, pi1) -> bool:
        """64-byte proof equality."""
        return _vdpf.verify(blk.words(pi0).cpu(), blk.words(pi1).cpu())

    def eval_all(self, party: int, s0, cws, cs, ocw,
                 fold: str = "reference"):
        """Full-domain evaluation of one key and its proof: (ys
        [2^in_bits, 4], pi [4, 4]). ``fold``: "reference" (the reference's
        flat chain, 2^n dependent hashes in one chain kernel), "tree" (a Merkle
        fold, one batched H' a level) or "chunked" (chains of 256, then a
        chain of their proofs). The folds give different proofs: both
        parties must pick the same one."""
        if fold not in _vdpf.FOLDS:
            raise ValueError(f"fold must be one of {_vdpf.FOLDS}, got "
                             f"{fold!r}")
        return eval_all_cuda.vdpf_eval_all(
            self.prg, self.hashes, self.group, self.in_bits, int(party),
            self._blocks(s0), self._blocks(cws), self._blocks(cs),
            self._blocks(ocw), fold)


class GrottoDcf(_TreeScheme):
    """Grotto DCF over F2 (the reference's grotto_dcf.cuh): the parties'
    shares XOR to 1[alpha <= x], from a DPF key with beta = 0 over
    ``Bytes`` and the ChaCha or AES-MMO PRG (mul=2).

    Keys: cws (in_bits+1, 8) int32, the DPF's wire layout. ``preprocess``
    expands a party's key into a ``ParityTree`` (the reference's
    preprocessing), ``preprocess_prefix`` into a ``PrefixTable`` (the
    packed full-domain prefix parities); ``eval`` answers point queries
    against either, and ``eval_all`` gives every x's share. On the card
    the leaf control bits come from the DPF EvalAll kernel's seeds
    epilogue (``eval_all_cuda.expand_leaves``) at every in_bits.
    """

    MUL = 2

    def __init__(self, in_bits: int, prg=None, device="cuda"):
        super().__init__(in_bits, groups.Bytes(), prg, device)

    def gen(self, s0s, alpha) -> torch.Tensor:
        """One key: s0s [2, 4], alpha an int (or lanes). Returns cws
        [in_bits+1, 8] through the DPF Gen kernel."""
        s0s, alpha, _ = self._one(s0s, alpha, (0, 0, 0, 0))
        return _grotto.gen(self.prg, self.in_bits, s0s, alpha)[0]

    def preprocess(self, party: int, s0, cws) -> _grotto.ParityTree:
        return _grotto.preprocess(self.prg, self.in_bits, int(party),
                                  self._blocks(s0), self._blocks(cws))

    def preprocess_prefix(self, party: int, s0, cws) -> _grotto.PrefixTable:
        """The packed full-domain prefix table: its queries are one gather
        each (``schemes.grotto_dcf.PrefixTable``)."""
        return _grotto.build_prefix_table(self.eval_all(party, s0, cws),
                                          int(party))

    def eval(self, pt, xs) -> torch.Tensor:
        """Shares of 1[alpha <= x], int32 0/1 [B] ([] for a single int x),
        against a PrefixTable (xs below 2^32) or a ParityTree."""
        if isinstance(pt, _grotto.PrefixTable):
            x = blk.words(np.asarray(xs, dtype=np.uint64).reshape(-1)
                          if not isinstance(xs, torch.Tensor) else xs,
                          self.device)
            y = _grotto.eval_prefix(pt, x)
        else:
            x = blk.pack_inputs(xs, self.in_bits, self.device).reshape(-1, 4)
            y = _grotto.eval_points(pt, x)
        return y[0] if isinstance(xs, (int, np.integer)) else y

    def eval_all(self, party: int, s0, cws) -> torch.Tensor:
        """Every x's share, int32 0/1 [2^in_bits]."""
        return _grotto.eval_all(self.prg, self.in_bits, int(party),
                                self._blocks(s0), self._blocks(cws))


class Vdmpf(_TreeScheme):
    """Verifiable multi-point function (the reference's vdmpf.cuh): t >= 30
    points Cuckoo-hashed into m buckets, each with an inner VDPF (ChaCha
    or AES-MMO, mul=2) over 2^bucket_bits, keyed with BLAKE3 or SHA-256.

    ``max_points`` sizes the bucket array (>= 30); ``bucket_bits`` bounds
    the inner domain (by default the smallest that fits the largest
    runtime bucket at t = 30). Keys are ``schemes.vdmpf.VdmpfKey``. On the
    card, routing is one launch of ``csrc/feistel.cu``, the inner evals
    one of the fused VDPF kernel, and the folds run the hash kernels.
    """

    MUL = 2

    def __init__(self, in_bits: int, max_points: int = 30,
                 bucket_bits: int | None = None, group=None, prg=None,
                 hash_iv=None, hashes=None, kappa: int = _vdmpf.KAPPA,
                 ch_lambda: int = _vdmpf.CH_LAMBDA, device="cuda"):
        super().__init__(in_bits, group, prg, device)
        self.max_points = max_points
        self.kappa = kappa
        self.ch_lambda = ch_lambda
        self.m = _cuckoo.ch_bucket(max_points, ch_lambda)
        if bucket_bits is None:
            m_min = _cuckoo.ch_bucket(30, ch_lambda)
            bucket_bits = max(1, ceil_log2(
                ((1 << in_bits) * kappa + m_min - 1) // m_min + 1))
        self.bucket_bits = bucket_bits
        if hashes is None:
            hashes = Blake3(DEFAULT_HASH_IV if hash_iv is None else hash_iv)
        vdpf_cuda.hash_kind(hashes, self.device)  # others: the CPU only
        self.hashes = hashes
        self._prp = None  # the PRP of the last key evaluated

    def _key_prp(self, key: _vdmpf.VdmpfKey):
        """The key's PRP: kept from the last call while sigma is the
        same (both parties' keys share it), else made anew."""
        if self._prp is None or self._prp.sigma != bytes(key.sigma):
            self._prp = _vdmpf.key_prp(key, self.in_bits, self.kappa)
        return self._prp

    def gen(self, sigma, s0s, alphas, betas, ch_retry: int = 1000):
        """sigma 16 bytes; s0s [m, 2, 4]; alphas t ints (t >= 30); betas
        [t, 4]. Returns (key0, key1, fail)."""
        return _vdmpf.gen(self.prg, self.hashes, self.group, self.in_bits,
                          self.bucket_bits, self.max_points, sigma,
                          self._blocks(s0s), [int(a) for a in alphas],
                          self._blocks(betas), self.kappa, self.ch_lambda,
                          ch_retry)

    def gen_retry(self, rng, alphas, betas, max_tries: int = 16):
        """Draw sigma (16 bytes) and then s0s [m, 2, 4] from the numpy
        Generator ``rng`` until Gen succeeds: the JAX package's draws, so
        the same ``rng`` gives the same keys. Returns (key0, key1)."""
        for _ in range(max_tries):
            sigma = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
            s0s = rng.integers(0, 2**32, size=(self.m, 2, 4))
            k0, k1, fail = self.gen(sigma, s0s, alphas, betas)
            if not fail:
                return k0, k1
        raise RuntimeError("vdmpf gen retry budget exhausted")

    def batch_eval(self, party: int, key: _vdmpf.VdmpfKey, xs,
                   fold: str = "tree"):
        """(ys [eta, 4], pi [4, 4]) at xs: [eta] words for in_bits <= 32,
        [eta, 4] lanes (or ints) above. ``fold``: "tree" (a Merkle fold,
        one batched H' a level) or "reference" (the reference's chains,
        byte-compatible with vdmpf.cuh:242-268); both parties must pick
        the same one. A point at or above 2^in_bits raises ValueError."""
        return _vdmpf.batch_eval(self.prg, self.hashes, self.group,
                                 self.in_bits, self.bucket_bits, int(party),
                                 key, self._inputs(xs), self.kappa, fold,
                                 self._key_prp(key))

    @staticmethod
    def verify(pi0, pi1) -> bool:
        """64-byte proof equality."""
        return _vdmpf.verify(blk.words(pi0).cpu(), blk.words(pi1).cpu())
