"""The host engine: a C++ library for every scheme, reached through ctypes.

Counterpart of ``fss_tpu.native``: the same C++ source (the port's own
copy, ``src/fss_native.cpp``) with the ChaCha and AES-128-MMO PRGs
(AES-NI, VAES-512 where the host has it), SHA-256 and BLAKE3, and DPF,
DCF, Half-Tree, VDPF, Grotto DCF and VDMPF Gen, Eval and EvalAll on the
CPU. It is the port's engine for hosts without a card and an oracle that
owes nothing to the kernels: on the same inputs it gives the kernels'
bytes.

``engine()`` returns the process's ``NativeEngine``; its methods have the
JAX package's names and argument order. Inputs are CPU tensors in the
port's contract, int32 words holding the uint32 bits and int64 where the
C ABI takes ``uint64_t`` (int32 words there are zero-extended), or the
numpy arrays, ints and bytes that the JAX package's engine takes. A
contiguous tensor of the right dtype is passed by its pointer, with no
copy. Outputs are CPU tensors of the same contract (uint8 for bytes). A
tensor on another device raises ValueError: the engine moves nothing
between devices.

The library is built by g++ at first use, never at import, into
``build/fss_tpu_torch/`` beside the kernels' libraries, named by a digest
of the source and the flags. The flags add the VAES-512 paths where this
host's ``/proc/cpuinfo`` lists their features. Each build writes a name
of its own process and thread, then renames it into place, so that
processes building at once never see each other's partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np
import torch

from fss_tpu_torch import _build

SRC = pathlib.Path(__file__).resolve().parent / "src" / "fss_native.cpp"
BUILD_DIR = _build.BUILD_DIR
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-maes", "-msse4.2")
VAES512_FLAGS = ("-mvaes", "-mavx512f", "-mavx512bw", "-mavx512vl",
                 "-mavx512dq", "-DFSS_BUILD_VAES512=1")

PRG_CHACHA = 0
PRG_AES128_MMO = 1
GROUP_BYTES = 0
GROUP_UINT = 1

MASK64 = (1 << 64) - 1

# Each C entry point's result and arguments: i int, I uint32_t, q int64_t,
# Q uint64_t, p a pointer.
_ABI = {
    "fss_native_has_aesni": (ctypes.c_int, ""),
    "fss_prg": (None, "iippipp"),
    "fss_dpf_gen": (None, "iippiiipQQpp"),
    "fss_dpf_gen_batch": (None, "iippiiippppqp"),
    "fss_dpf_eval": (None, "iippiiiippppqp"),
    "fss_dpf_eval_batch": (None, "iippiiiipppqp"),
    "fss_dpf_eval_all": (None, "iippiiiippp"),
    "fss_dcf_gen": (None, "iippiiiipQQpp"),
    "fss_dcf_eval": (None, "iippiiiippppqp"),
    "fss_dcf_eval_all": (None, "iippiiiipppp"),
    "fss_dcf_gen_batch": (None, "iippiiiipppqp"),
    "fss_ht_gen": (None, "iippiiippQQppp"),
    "fss_ht_gen_batch": (None, "iippiiippppqpp"),
    "fss_ht_eval": (None, "iippiiiippppppqp"),
    "fss_ht_eval_all": (None, "iippiiiippppp"),
    "fss_vdpf_gen": (ctypes.c_int, "iippiipiipQQpppp"),
    "fss_vdpf_gen_batch": (None, "iippiipiipppqpppp"),
    "fss_vdpf_eval_batch": (None, "iippiipiiippppppqpp"),
    "fss_vdpf_eval_all": (None, "iippiipiiipppppp"),
    "fss_vdpf_prove": (None, "ippqpp"),
    "fss_vdpf_prove1_batch": (None, "ippqpp"),
    "fss_grotto_preprocess": (None, "iippiipppp"),
    "fss_grotto_eval_batch": (None, "ippqp"),
    "fss_grotto_pack_tree": (None, "pQp"),
    "fss_grotto_eval_batch_packed": (None, "ippqp"),
    "fss_grotto_eval_all": (None, "iippiipppp"),
    "fss_sha256": (None, "pqp"),
    "fss_blake3_compress": (None, "ppIp"),
    "fss_vdmpf_gen": (ctypes.c_int, "iippiipiipQiiiipppiippp"),
    "fss_vdmpf_batch_eval": (None, "iippiipiiipQiiipppppqpp"),
    "fss_vdmpf_route": (None, "pQiipqpp"),
    "fss_prp_permu_batch": (None, "pQpqp"),
}
_CTYPES = {"i": ctypes.c_int, "I": ctypes.c_uint32, "q": ctypes.c_int64,
           "Q": ctypes.c_uint64, "p": ctypes.c_void_p}
# Each tensor dtype's unsigned numpy dtype (the JAX engine's) and the
# signed one with the same bits.
_NP = {torch.int32: (np.uint32, np.int32),
       torch.int64: (np.uint64, np.int64),
       torch.uint8: (np.uint8, np.uint8)}

_ENGINE = None
_lock = threading.Lock()


def host_flags() -> tuple:
    """g++'s flags for this host: ``FLAGS``, plus ``VAES512_FLAGS`` where
    its CPU has VAES and AVX-512 F/BW/VL (the paths that advance four AES
    blocks an instruction)."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
    except OSError:
        return FLAGS
    if all(f" {feature}" in info
           for feature in ("vaes", "avx512f", "avx512bw", "avx512vl")):
        return FLAGS + VAES512_FLAGS
    return FLAGS


def library(flags: tuple) -> pathlib.Path:
    """The library built from ``SRC`` with ``flags``, built or not."""
    digest = hashlib.sha256(SRC.read_bytes() + b"|"
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fss_native-{digest}.so"


def build() -> pathlib.Path:
    """Compile the engine unless this host's library exists; return its
    path. Raises RuntimeError with g++'s output if the compile fails."""
    flags = host_flags()
    so = library(flags)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _in(vals, dtype=torch.int32, count: int | None = None,
        name: str = "input") -> torch.Tensor:
    """``vals`` as a contiguous CPU tensor of ``dtype`` (int32 words,
    int64 for uint64_t, uint8 bytes): a tensor that is one already as it
    is, anything else converted as the JAX package's engine converts it.
    Raises ValueError unless it holds ``count`` elements (where given)."""
    if isinstance(vals, torch.Tensor):
        if vals.device.type != "cpu":
            raise ValueError(f"{name} is on {vals.device}: the host engine "
                             f"takes CPU tensors and copies nothing across "
                             f"devices")
        if vals.dtype == dtype:
            t = vals.contiguous()
        else:
            arr = vals.numpy()
            if vals.dtype == torch.int32:
                arr = arr.view(np.uint32)  # zero-extended to 64 bits
            t = _in(arr, dtype, None, name)
    else:
        if isinstance(vals, (bytes, bytearray)):
            vals = np.frombuffer(vals, dtype=np.uint8)
        unsigned, signed = _NP[dtype]
        arr = np.array(vals, dtype=unsigned, copy=True, order="C")
        t = torch.from_numpy(arr.view(signed))
    if count is not None and t.numel() != count:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{count}")
    return t


def _out(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype)


def _prg(nonce, aes_keys, rounds) -> tuple:
    """The PRG arguments of every tree scheme's entry point: the nonce's
    two words, the AES keys' bytes (NULL without them), the rounds."""
    words = _in([0, 0] if nonce is None
                else [int(n) & 0xFFFFFFFF for n in nonce], count=2,
                name="nonce")
    keys = _in(b"".join(aes_keys), torch.uint8, name="aes_keys") \
        if aes_keys else None
    return words, keys, int(rounds)


def _hash_key(hash_kind: int, hash_key) -> torch.Tensor:
    """SHA-256's 16 key bytes (hash_kind 0) or BLAKE3's 32 IV bytes (1)."""
    if hash_kind not in (0, 1):
        raise ValueError(f"hash_kind must be 0 (sha256) or 1 (blake3), "
                         f"got {hash_kind}")
    return _in(hash_key, torch.uint8, 32 if hash_kind else 16, "hash_key")


def _alpha(alpha) -> tuple:
    a = int(alpha)
    return a & MASK64, a >> 64


def _split_u128(xs) -> tuple:
    """(lo, hi) int64 halves of the inputs: an int tensor or an integer
    array in one pass, Python ints (as an object array or a list) above
    2^64 one by one."""
    if isinstance(xs, torch.Tensor) or (
            isinstance(xs, np.ndarray) and xs.dtype != object
            and np.issubdtype(xs.dtype, np.integer)):
        lo = _in(xs, torch.int64, name="xs").reshape(-1)
        return lo, torch.zeros_like(lo)
    xs = np.atleast_1d(np.asarray(xs, dtype=object)).reshape(-1)
    lo = _in([int(x) & MASK64 for x in xs], torch.int64, name="xs")
    hi = _in([int(x) >> 64 for x in xs], torch.int64, name="xs")
    return lo, hi


def _pred_lt(pred) -> int:
    """``"lt"``/``"gt"`` or the C flag (1 for lt)."""
    if isinstance(pred, str):
        if pred not in ("lt", "gt"):
            raise ValueError(f"pred must be 'lt' or 'gt', got {pred!r}")
        return int(pred == "lt")
    return int(pred)


class NativeEngine:
    """The loaded library. Keys use the wire layouts of the JAX package
    and of the port: cws [in_bits+1, 8] (DPF, DCF), [in_bits, 8] and
    ocw [4] (Half-Tree), [in_bits, 8], cs [4, 4] and ocw [4] (VDPF)."""

    def __init__(self):
        self._lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _ABI.items():
            fn = getattr(self._lib, name)
            fn.restype = res
            fn.argtypes = [_CTYPES[c] for c in args]

    def _call(self, name: str, *args):
        """Call ``name`` with tensors passed by pointer; ``args`` keeps
        them alive for the call."""
        return getattr(self._lib, name)(*(
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args))

    @property
    def has_aesni(self) -> bool:
        return bool(self._lib.fss_native_has_aesni())

    def prg(self, prg_kind: int, mul: int, seed, nonce=None, aes_keys=None,
            rounds: int = 20) -> torch.Tensor:
        """One PRG call: [mul, 4] output blocks of a [4] seed."""
        out = _out(mul, 4)
        self._call("fss_prg", prg_kind, mul, *_prg(nonce, aes_keys, rounds),
                   _in(seed, count=4, name="seed"), out)
        return out

    # -- DPF ------------------------------------------------------------------

    def dpf_gen(self, in_bits: int, prg_kind: int, group_kind: int,
                group_bits: int, s0s, alpha: int, beta, nonce=None,
                aes_keys=None, rounds: int = 20) -> torch.Tensor:
        cws = _out(in_bits + 1, 8)
        self._call("fss_dpf_gen", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _in(s0s, count=8, name="s0s"), *_alpha(alpha),
                   _in(beta, count=4, name="beta"), cws)
        return cws

    def dpf_gen_batch(self, in_bits: int, prg_kind: int, group_kind: int,
                      group_bits: int, s0s_batch, alphas, betas, nonce=None,
                      aes_keys=None, rounds: int = 20) -> torch.Tensor:
        """n independent Gens in one call: s0s [n, 2, 4], alphas [n]
        (below 2^64), betas [n, 4] -> cws [n, in_bits+1, 8]."""
        lo = _in(alphas, torch.int64, name="alphas").reshape(-1)
        n = lo.numel()
        cws = _out(n, in_bits + 1, 8)
        self._call("fss_dpf_gen_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _in(s0s_batch, count=8 * n, name="s0s"), lo, None,
                   _in(betas, count=4 * n, name="betas"), n, cws)
        return cws

    def dpf_eval(self, in_bits: int, prg_kind: int, group_kind: int,
                 group_bits: int, party: int, s0, cws, xs, nonce=None,
                 aes_keys=None, rounds: int = 20) -> torch.Tensor:
        """One key at many points: [n, 4] shares."""
        lo, hi = _split_u128(xs)
        ys = _out(lo.numel(), 4)
        self._call("fss_dpf_eval", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"), lo, hi,
                   lo.numel(), ys)
        return ys

    def dpf_eval_batch(self, in_bits: int, prg_kind: int, group_kind: int,
                       group_bits: int, party: int, s0s, cws_batch, xs,
                       nonce=None, aes_keys=None,
                       rounds: int = 20) -> torch.Tensor:
        """Key i at point i (below 2^64): [n, 4] shares."""
        lo = _in(xs, torch.int64, name="xs").reshape(-1)
        n = lo.numel()
        ys = _out(n, 4)
        self._call("fss_dpf_eval_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(s0s, count=4 * n, name="s0s"),
                   _in(cws_batch, count=8 * (in_bits + 1) * n, name="cws"),
                   lo, n, ys)
        return ys

    def dpf_eval_all(self, in_bits: int, prg_kind: int, group_kind: int,
                     group_bits: int, party: int, s0, cws, nonce=None,
                     aes_keys=None, rounds: int = 20) -> torch.Tensor:
        ys = _out(1 << in_bits, 4)
        self._call("fss_dpf_eval_all", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"), ys)
        return ys

    # -- DCF ------------------------------------------------------------------

    def dcf_gen(self, in_bits: int, prg_kind: int, group_kind: int,
                group_bits: int, pred: str, s0s, alpha: int, beta,
                nonce=None, aes_keys=None, rounds: int = 20) -> torch.Tensor:
        cws = _out(in_bits + 1, 8)
        self._call("fss_dcf_gen", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _pred_lt(pred), _in(s0s, count=8, name="s0s"),
                   *_alpha(alpha), _in(beta, count=4, name="beta"), cws)
        return cws

    def dcf_gen_batch(self, in_bits: int, prg_kind: int, group_kind: int,
                      group_bits: int, pred_lt, s0s, alphas, betas,
                      nonce=None, aes_keys=None,
                      rounds: int = 20) -> torch.Tensor:
        """``pred_lt``: "lt"/"gt" or the C flag (1 for lt)."""
        lo = _in(alphas, torch.int64, name="alphas").reshape(-1)
        n = lo.numel()
        cws = _out(n, in_bits + 1, 8)
        self._call("fss_dcf_gen_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _pred_lt(pred_lt), _in(s0s, count=8 * n, name="s0s"), lo,
                   _in(betas, count=4 * n, name="betas"), n, cws)
        return cws

    def dcf_eval(self, in_bits: int, prg_kind: int, group_kind: int,
                 group_bits: int, party: int, s0, cws, xs, nonce=None,
                 aes_keys=None, rounds: int = 20) -> torch.Tensor:
        lo, hi = _split_u128(xs)
        ys = _out(lo.numel(), 4)
        self._call("fss_dcf_eval", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"), lo, hi,
                   lo.numel(), ys)
        return ys

    def dcf_eval_all(self, in_bits: int, prg_kind: int, group_kind: int,
                     group_bits: int, party: int, s0, cws, nonce=None,
                     aes_keys=None, rounds: int = 20) -> torch.Tensor:
        ys = _out(1 << in_bits, 4)
        self._call("fss_dcf_eval_all", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"), ys,
                   _out(1 << in_bits, 4))
        return ys

    # -- Half-Tree DPF ------------------------------------------------------

    def ht_gen(self, in_bits: int, prg_kind: int, group_kind: int,
               group_bits: int, hash_key, s0s, alpha: int, beta,
               nonce=None, aes_keys=None, rounds: int = 20):
        """(cws [in_bits, 8], ocw [4])."""
        cws, ocw = _out(in_bits, 8), _out(4)
        self._call("fss_ht_gen", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _in(hash_key, count=4, name="hash_key"),
                   _in(s0s, count=8, name="s0s"), *_alpha(alpha),
                   _in(beta, count=4, name="beta"), cws, ocw)
        return cws, ocw

    def ht_gen_batch(self, in_bits: int, prg_kind: int, group_kind: int,
                     group_bits: int, hash_key, s0s, alphas, betas,
                     nonce=None, aes_keys=None, rounds: int = 20):
        """(cws [n, in_bits, 8], ocws [n, 4])."""
        lo = _in(alphas, torch.int64, name="alphas").reshape(-1)
        n = lo.numel()
        cws, ocws = _out(n, in_bits, 8), _out(n, 4)
        self._call("fss_ht_gen_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   _in(hash_key, count=4, name="hash_key"),
                   _in(s0s, count=8 * n, name="s0s"), lo,
                   _in(betas, count=4 * n, name="betas"), n, cws, ocws)
        return cws, ocws

    def ht_eval(self, in_bits: int, prg_kind: int, group_kind: int,
                group_bits: int, party: int, hash_key, s0, cws, ocw, xs,
                nonce=None, aes_keys=None, rounds: int = 20) -> torch.Tensor:
        lo, hi = _split_u128(xs)
        ys = _out(lo.numel(), 4)
        self._call("fss_ht_eval", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(hash_key, count=4, name="hash_key"),
                   _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * in_bits, name="cws"),
                   _in(ocw, count=4, name="ocw"), lo, hi, lo.numel(), ys)
        return ys

    def ht_eval_all(self, in_bits: int, prg_kind: int, group_kind: int,
                    group_bits: int, party: int, hash_key, s0, cws, ocw,
                    nonce=None, aes_keys=None,
                    rounds: int = 20) -> torch.Tensor:
        ys = _out(1 << in_bits, 4)
        self._call("fss_ht_eval_all", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), group_kind, group_bits,
                   party, _in(hash_key, count=4, name="hash_key"),
                   _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * in_bits, name="cws"),
                   _in(ocw, count=4, name="ocw"), ys)
        return ys

    # -- VDPF (hash_kind 0: SHA-256, 16-byte key; 1: BLAKE3, 32-byte IV) ------

    def vdpf_gen(self, in_bits: int, prg_kind: int, hash_kind: int,
                 hash_key: bytes, group_kind: int, group_bits: int, s0s,
                 alpha: int, beta, nonce=None, aes_keys=None,
                 rounds: int = 20):
        """(cws [in_bits, 8], cs [4, 4], ocw [4], fail): where fail is 1
        the caller draws new seeds."""
        cws, cs, ocw = _out(in_bits, 8), _out(4, 4), _out(4)
        fail = self._call("fss_vdpf_gen", in_bits, prg_kind,
                          *_prg(nonce, aes_keys, rounds), hash_kind,
                          _hash_key(hash_kind, hash_key), group_kind,
                          group_bits, _in(s0s, count=8, name="s0s"),
                          *_alpha(alpha), _in(beta, count=4, name="beta"),
                          cws, cs, ocw)
        return cws, cs, ocw, int(fail)

    def vdpf_gen_batch(self, in_bits: int, prg_kind: int, hash_kind: int,
                       hash_key: bytes, group_kind: int, group_bits: int,
                       s0s, alphas, betas, nonce=None, aes_keys=None,
                       rounds: int = 20):
        """(cws [n, in_bits, 8], cs [n, 4, 4], ocws [n, 4], fails [n])."""
        lo = _in(alphas, torch.int64, name="alphas").reshape(-1)
        n = lo.numel()
        cws, cs, ocws, fails = (_out(n, in_bits, 8), _out(n, 4, 4),
                                _out(n, 4), _out(n))
        self._call("fss_vdpf_gen_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), hash_kind,
                   _hash_key(hash_kind, hash_key), group_kind, group_bits,
                   _in(s0s, count=8 * n, name="s0s"), lo,
                   _in(betas, count=4 * n, name="betas"), n, cws, cs, ocws,
                   fails)
        return cws, cs, ocws, fails

    def vdpf_eval_batch(self, in_bits: int, prg_kind: int, hash_kind: int,
                        hash_key: bytes, group_kind: int, group_bits: int,
                        party: int, s0, cws, cs, ocw, xs, nonce=None,
                        aes_keys=None, rounds: int = 20):
        """One key at many points: (ys [n, 4], pi_tildes [n, 4, 4])."""
        lo, hi = _split_u128(xs)
        n = lo.numel()
        ys, pts = _out(n, 4), _out(n, 4, 4)
        self._call("fss_vdpf_eval_batch", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), hash_kind,
                   _hash_key(hash_kind, hash_key), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * in_bits, name="cws"),
                   _in(cs, count=16, name="cs"),
                   _in(ocw, count=4, name="ocw"), lo, hi, n, ys, pts)
        return ys, pts

    def vdpf_prove(self, hash_kind: int, hash_key: bytes, pi_tildes,
                   cs) -> torch.Tensor:
        """The reference's flat fold of pi_tildes [n, 4, 4] from cs."""
        pts = _in(pi_tildes, name="pi_tildes")
        pi = _out(4, 4)
        self._call("fss_vdpf_prove", hash_kind,
                   _hash_key(hash_kind, hash_key), pts, pts.numel() // 16,
                   _in(cs, count=16, name="cs"), pi)
        return pi

    def vdpf_prove1_batch(self, hash_kind: int, hash_key: bytes,
                          pi_tildes, cs) -> torch.Tensor:
        """n independent single-fold proofs: pis[j] = Prove([pt_j], cs)."""
        pts = _in(pi_tildes, name="pi_tildes")
        n = pts.numel() // 16
        pis = _out(n, 4, 4)
        self._call("fss_vdpf_prove1_batch", hash_kind,
                   _hash_key(hash_kind, hash_key), pts, n,
                   _in(cs, count=16, name="cs"), pis)
        return pis

    def vdpf_eval_all(self, in_bits: int, prg_kind: int, hash_kind: int,
                      hash_key: bytes, group_kind: int, group_bits: int,
                      party: int, s0, cws, cs, ocw, nonce=None,
                      aes_keys=None, rounds: int = 20):
        """(ys [2^in_bits, 4], pi [4, 4]) with the reference's fold."""
        ys, pi = _out(1 << in_bits, 4), _out(4, 4)
        self._call("fss_vdpf_eval_all", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), hash_kind,
                   _hash_key(hash_kind, hash_key), group_kind, group_bits,
                   party, _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * in_bits, name="cws"),
                   _in(cs, count=16, name="cs"),
                   _in(ocw, count=4, name="ocw"), ys, pi)
        return ys, pi

    # -- Grotto DCF ---------------------------------------------------------

    def grotto_preprocess(self, in_bits: int, prg_kind: int, party: int,
                          s0, cws, nonce=None, aes_keys=None,
                          rounds: int = 20) -> torch.Tensor:
        """The parity tree: [2^(in_bits+1) - 1] uint8, level order."""
        n = 1 << in_bits
        pt = _out(2 * n - 1, dtype=torch.uint8)
        self._call("fss_grotto_preprocess", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), party,
                   _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"),
                   _out(n, 4), pt)
        return pt

    def grotto_eval_batch(self, in_bits: int, pt, xs) -> torch.Tensor:
        xs = _in(xs, torch.int64, name="xs").reshape(-1)
        out = _out(xs.numel(), dtype=torch.uint8)
        self._call("fss_grotto_eval_batch", in_bits,
                   _in(pt, torch.uint8, (2 << in_bits) - 1, "pt"), xs,
                   xs.numel(), out)
        return out

    def grotto_pack_tree(self, pt) -> torch.Tensor:
        """The parity tree as bits, [ceil(len / 64)] int64 words."""
        pt = _in(pt, torch.uint8, name="pt")
        packed = _out((pt.numel() + 63) // 64, dtype=torch.int64)
        self._call("fss_grotto_pack_tree", pt, pt.numel(), packed)
        return packed

    def grotto_eval_batch_packed(self, in_bits: int, packed,
                                 xs) -> torch.Tensor:
        xs = _in(xs, torch.int64, name="xs").reshape(-1)
        out = _out(xs.numel(), dtype=torch.uint8)
        self._call("fss_grotto_eval_batch_packed", in_bits,
                   _in(packed, torch.int64, ((2 << in_bits) + 62) // 64,
                       "packed"), xs, xs.numel(), out)
        return out

    def grotto_eval_all(self, in_bits: int, prg_kind: int, party: int, s0,
                        cws, nonce=None, aes_keys=None,
                        rounds: int = 20) -> torch.Tensor:
        n = 1 << in_bits
        ys = _out(n, dtype=torch.uint8)
        self._call("fss_grotto_eval_all", in_bits, prg_kind,
                   *_prg(nonce, aes_keys, rounds), party,
                   _in(s0, count=4, name="s0"),
                   _in(cws, count=8 * (in_bits + 1), name="cws"),
                   _out(n, 4), ys)
        return ys

    # -- Hashes ---------------------------------------------------------------

    def sha256(self, data: bytes) -> bytes:
        out = _out(32, dtype=torch.uint8)
        data = _in(data, torch.uint8, name="data")
        self._call("fss_sha256", data, data.numel(), out)
        return out.numpy().tobytes()

    def blake3_compress(self, iv, m, block_len: int) -> torch.Tensor:
        """BLAKE3's keyed compression (counter 0): [16] words."""
        out = _out(16)
        self._call("fss_blake3_compress", _in(iv, count=8, name="iv"),
                   _in(m, count=16, name="m"), block_len, out)
        return out

    # -- VDMPF and the PRP -------------------------------------------------

    def vdmpf_gen(self, bucket_bits: int, prg_kind: int, hash_kind: int,
                  hash_key: bytes, group_kind: int, group_bits: int,
                  sigma: bytes, n: int, m: int, m_rt: int, b_size: int,
                  kappa: int, s0s, alphas, betas, ch_retry: int = 1000,
                  nonce=None, aes_keys=None, rounds: int = 20):
        """Cuckoo placement with the reference's mt19937(42) stream and
        each bucket's VDPF Gen. s0s [m, 2, 4]; returns (cws
        [m, bucket_bits, 8], cs [m, 4, 4], ocw [m, 4], fail)."""
        a = _in(alphas, torch.int64, name="alphas").reshape(-1)
        t = a.numel()
        cws, cs, ocw = _out(m, bucket_bits, 8), _out(m, 4, 4), _out(m, 4)
        fail = self._call(
            "fss_vdmpf_gen", bucket_bits, prg_kind,
            *_prg(nonce, aes_keys, rounds), hash_kind,
            _hash_key(hash_kind, hash_key), group_kind, group_bits,
            _in(sigma, torch.uint8, 16, "sigma"), n, m, m_rt, b_size, kappa,
            _in(s0s, count=8 * m, name="s0s"), a,
            _in(betas, count=4 * t, name="betas"), t, ch_retry, cws, cs,
            ocw)
        return cws, cs, ocw, int(fail)

    def vdmpf_batch_eval(self, bucket_bits: int, prg_kind: int,
                         hash_kind: int, hash_key: bytes, group_kind: int,
                         group_bits: int, party: int, sigma: bytes,
                         n: int, m: int, b_size: int, kappa: int, s0, cws,
                         cs, ocw, xs, nonce=None, aes_keys=None,
                         rounds: int = 20):
        """Routing, the buckets' VDPF evals, the group fold and the
        reference's proof chain: (ys [eta, 4], pi [4, 4]). s0 [m, 4],
        cws [m, bucket_bits, 8], cs [m, 4, 4], ocw [m, 4]."""
        xs = _in(xs, torch.int64, name="xs").reshape(-1)
        eta = xs.numel()
        ys, pi = _out(eta, 4), _out(4, 4)
        self._call(
            "fss_vdmpf_batch_eval", bucket_bits, prg_kind,
            *_prg(nonce, aes_keys, rounds), hash_kind,
            _hash_key(hash_kind, hash_key), group_kind, group_bits, party,
            _in(sigma, torch.uint8, 16, "sigma"), n, m, b_size, kappa,
            _in(s0, count=4 * m, name="s0"),
            _in(cws, count=8 * bucket_bits * m, name="cws"),
            _in(cs, count=16 * m, name="cs"),
            _in(ocw, count=4 * m, name="ocw"), xs, eta, ys, pi)
        return ys, pi

    def vdmpf_route(self, sigma: bytes, n: int, b_size: int, kappa: int,
                    xs):
        """Each point's (bucket, index) under each of the kappa hash
        functions: two [eta, kappa] int32 tensors."""
        xs = _in(xs, torch.int64, name="xs").reshape(-1)
        eta = xs.numel()
        bucket, index = _out(eta, kappa), _out(eta, kappa)
        self._call("fss_vdmpf_route", _in(sigma, torch.uint8, 16, "sigma"),
                   n, b_size, kappa, xs, eta, bucket, index)
        return bucket, index

    def prp_permu_batch(self, sigma: bytes, domain: int,
                        xs) -> torch.Tensor:
        """The AES-128 Feistel PRP over [0, domain) (the reference's
        aes128_feistel.cuh) of each x: [n] int64. Needs AES-NI."""
        if not self.has_aesni:
            raise RuntimeError("prp_permu_batch needs AES-NI")
        xs = _in(xs, torch.int64, name="xs").reshape(-1)
        ys = _out(xs.numel(), dtype=torch.int64)
        self._call("fss_prp_permu_batch",
                   _in(sigma, torch.uint8, 16, "sigma"), domain, xs,
                   xs.numel(), ys)
        return ys


def engine() -> NativeEngine:
    """The process's engine (built and loaded at the first call)."""
    global _ENGINE
    with _lock:
        if _ENGINE is None:
            _ENGINE = NativeEngine()
        return _ENGINE
