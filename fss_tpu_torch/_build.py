"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, never at import: one ``nvcc`` per source, all
started together. Libraries go to ``build/fss_tpu_torch/`` beside the
package (git-ignored), named by a digest of their sources and flags, so a
later process reuses them and an edited source is rebuilt.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0 and counts the launch in :data:`launches`, by kernel: a
source with one kernel counts under its own name (with ``_aes`` appended
when it ran the AES-128-MMO PRG), and ``blake3.cu``, ``sha256.cu`` and
``feistel.cu`` under one name per entry point (``KERNELS``).

The PRG reaches a kernel as one host pointer to an ``fss::PrgArg``
(``csrc/prg.cuh``), built by :func:`prg_arg` from a ``ChaCha`` or
``AesMmo`` object; the entry point picks the kernel's instantiation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from fss_tpu_torch.prg.aes import AesMmo
from fss_tpu_torch.prg.chacha import ChaCha
from fss_tpu_torch.utils.profiling import span

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "fss_tpu_torch"
SOURCES = ("dpf_eval", "dpf_gen", "dpf_eval_all", "dcf_eval", "dcf_gen",
           "dcf_eval_all", "ht_eval", "ht_gen", "ht_eval_all", "blake3",
           "sha256", "vdpf_eval", "feistel", "pir_contract")
HEADERS = ("chacha.cuh", "aes.cuh", "prg.cuh", "group.cuh", "dcf_acc.cuh",
           "dpf_walk.cuh", "subtree.cuh", "parties.cuh", "blake3.cuh",
           "sha256.cuh", "ring.cuh")  # digested by every .so
PRG_SOURCES = tuple(s for s in SOURCES
                    if s not in ("blake3", "sha256", "feistel",
                                 "pir_contract"))
KERNELS = (*PRG_SOURCES, *(f"{s}_aes" for s in PRG_SOURCES),
           "blake3_xor_hash", "blake3_hash64", "blake3_chain",
           "sha256_xor_hash", "sha256_hash64", "sha256_chain",
           "feistel_route", "feistel_permute", "pir_contract")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per kernel since the last reset_launches().
launches = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()  # launches from several threads


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launched(kernels, since: dict | None = None) -> dict:
    """The launches of ``kernels`` since the last reset_launches(), or
    since ``since`` (a copy of ``launches`` taken earlier). Raises
    RuntimeError naming those that were not launched."""
    counts = {k: launches[k] - (since or {}).get(k, 0) for k in kernels}
    missing = [k for k, v in counts.items() if not v]
    if missing:
        raise RuntimeError(f"kernels not launched: {missing} ({counts})")
    return counts


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library(name: str) -> pathlib.Path:
    """The shared library of source ``name``, built or not."""
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build() -> dict[str, str]:
    """Compile every source not built yet and load all libraries.

    Returns each source's ``ptxas -v`` report (registers, spills).
    Raises RuntimeError with the compiler's output if a build fails.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in SOURCES:
            if name in _libs:
                continue
            so = library(name)
            if not so.exists():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                jobs[name] = (so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        failed = []
        for name, (so, tmp, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
                continue
            so.with_suffix(".log").write_text(out)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                so = library(name)
                _libs[name] = ctypes.CDLL(str(so))
                log = so.with_suffix(".log")
                _logs[name] = log.read_text() if log.exists() else ""
        return dict(_logs)


def function(source: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``source``'s library, typed."""
    if source not in _libs:
        build()
    fn = getattr(_libs[source], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _launch_span(source, *args, kernel=None, **kwargs) -> str:
    return f"launch.{kernel or source}"


def launch(source: str, fn, *args, device: torch.device,
           kernel: str | None = None) -> None:
    """Call a C entry point on ``device``'s current stream, raise if the
    launch failed, and count it under ``kernel`` (default: the source).
    Recorded as the span ``launch.<kernel>``."""
    launch_many(source, fn, (args,), device=device, kernel=kernel)


@span(_launch_span)
def launch_many(source: str, fn, calls, *, device: torch.device,
                kernel: str | None = None) -> None:
    """:func:`launch` of each argument tuple of ``calls``, in order, under
    one device guard and one lookup of the stream: each counted as a
    launch, all recorded as one span ``launch.<kernel>``. Raises at the
    first launch that fails."""
    done = 0
    try:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for args in calls:
                rc = fn(*args, stream)
                if rc != 0:
                    raise RuntimeError(f"{source} kernel launch failed: "
                                       f"CUDA error {rc}")
                done += 1
    finally:
        with _count_lock:
            launches[kernel or source] += done


class PrgArg(ctypes.Structure):
    """``fss::PrgArg`` of ``csrc/prg.cuh``."""

    _fields_ = [("kind", ctypes.c_uint32), ("n0", ctypes.c_uint32),
                ("n1", ctypes.c_uint32), ("rounds", ctypes.c_uint32),
                ("rk", ctypes.c_uint32 * 176)]


def check_prg(prg, mul: int) -> None:
    """Raise unless ``prg`` is a ChaCha or AesMmo with ``mul`` outputs."""
    if not isinstance(prg, (ChaCha, AesMmo)) or prg.mul != mul:
        raise ValueError(f"the kernel needs the ChaCha or AES-MMO PRG with "
                         f"mul={mul}, got {prg!r}")


def prg_arg(prg, mul: int):
    """A PRG object -> (a pointer to its host ``PrgArg``, the entry
    points' ``const void* prg``; the launch-count suffix: "" for ChaCha,
    "_aes" for AES-128-MMO). Raises unless ``prg`` is a ChaCha or AesMmo
    with ``mul`` outputs, the kernel's."""
    check_prg(prg, mul)
    arg = PrgArg()
    if isinstance(prg, ChaCha):
        arg.kind, (arg.n0, arg.n1), arg.rounds = 0, prg.nonce, prg.rounds
        return ctypes.pointer(arg), ""
    arg.kind = 1
    words = prg.round_keys.reshape(-1)
    arg.rk[:words.size] = [int(w) for w in words.astype(np.uint32)]
    return ctypes.pointer(arg), "_aes"


def check(t: torch.Tensor, name: str, device: torch.device,
          shapes) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor on ``device`` whose
    shape is one of ``shapes``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) not in [tuple(s) for s in shapes]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected one "
                         f"of {[tuple(s) for s in shapes]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


P = ctypes.c_void_p
I64 = ctypes.c_int64
INT = ctypes.c_int
U32 = ctypes.c_uint32
U64 = ctypes.c_uint64
