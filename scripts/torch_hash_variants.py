#!/usr/bin/env python3
"""The SHA-256 H' kernels' designs against each other and the parent's, on
one GPU.

    python3 scripts/torch_hash_variants.py [--parent DIR] [--chain-rows 4096]
        [--log2-rows 20] [--fold-bits 24] [--reps 10]

Times, for each variant of ``csrc/sha256.cu``:

  chain      ``sha256_cuda.chain`` (the VDPF's flat proof) on
             ``--chain-rows`` points, ms and clocks a row at the card's
             max SM clock;
  hash64     ``sha256_cuda.hash64`` on 2^log2-rows rows;
  xor_hash   ``sha256_cuda.xor_hash`` (B-12) on 2^log2-rows rows;
  tree_fold  ``vdpf_cuda.fold(Sha256, ..., "tree")`` over 2^fold-bits rows
             (the SHA-256 VDPF EvalAll's fold: one hash64 launch a level);

and, for the parent's tree and the port's, ``vdpf_eval`` with SHA-256
(2^log2-rows keys, 16 bits). The variants are copies of ``csrc/`` under
``build/`` with the design choices at the top of ``sha256.cu`` patched:
the adds of the chain lane and helper (``ChainAdd``) and of hash64's
rounds and schedule (``H64Add``, ``H64SchedAdd``: ``PlainAdd`` IADD3s,
``FmaAdd`` IMADs, ``MixedAdd`` both, ``csrc/sha256.cuh``), the chain's
helper lane (``kChainHelper``), its hand-overs a row (``kPieces``), the
schedule words the chain lane computes itself (``kSelfWords``), the ring
(``kRing``), hash64's CTA (``kH64Threads``) and rows a thread
(``kH64Rows``). ``--parent DIR``
(a checkout of the parent commit, e.g. ``git archive`` unpacked under
``build/``) adds its ``csrc/`` first and last, and the port's design runs
second and second to last, so the drift is bounded and the parent and the
change compare in one call. Each variant's outputs are held byte-exact
against the plain versions (computed once: the chain at 0, 1, kRing - 1,
kRing, kRing + 1 and ``--chain-rows`` points, hash64 and xor_hash on all
rows, the fold's proof, vdpf_eval's outputs) before it is timed with CUDA
events. Each line carries ptxas's registers of the hash64 and chain
kernels and their SASS counts split by pipe (``chip_smoke.sass_usage``),
for the port's design and the chain's variants the chain's roles alone
(``chip_smoke.chain_role_usage``), and the port's first line the SM clock
and power draw under a sustained loop of hash64 and of the chain
(nvidia-smi, every 100 ms, the first two samples left out). One JSON
line a variant, after the card's name and power limit (nvidia-smi).
Without a card the script exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SHA_KEY = (0xA1B2C3D4, 0x11223344, 0x55667788, 0x99AABBCC)
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
# name -> the choices patched into sha256.cu (a regex of the line's start
# -> its new value).
VARIANTS = {
    "chain/self0-pieces12": {"kSelfWords": "0", "kPieces": "12"},
    "chain/self8-pieces10": {"kPieces": "10"},
    "chain/self16-pieces4": {"kSelfWords": "16", "kPieces": "4"},
    "chain/self16-pieces8": {"kSelfWords": "16", "kPieces": "8"},
    "chain/self24-pieces6": {"kSelfWords": "24", "kPieces": "6"},
    "chain/no-helper": {"kChainHelper": "false"},
    "chain/fma-adds": {"ChainAdd": "fss::FmaAdd"},
    "chain/ring4": {"kRing": "4"},
    "hash64/fma-adds": {"H64SchedAdd": "fss::FmaAdd"},
    "hash64/plain-adds": {"H64Add": "fss::PlainAdd"},
    "hash64/mixed-adds": {"H64Add": "fss::MixedAdd",
                          "H64SchedAdd": "fss::MixedAdd"},
    "hash64/t256": {"kH64Threads": "256"},
    "hash64/rows2": {"kH64Rows": "2"},
}


def patch(src: pathlib.Path, name: str, choices: dict,
          root: pathlib.Path = REPO / "build") -> pathlib.Path:
    """A copy of csrc/ under ``root`` with sha256.cu's ``choices``."""
    d = root / f"csrc_hash_{name.replace('/', '_')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    f = d / "sha256.cu"
    text = f.read_text()
    for key, value in choices.items():
        text, n = re.subn(
            rf"^(using {key} = |constexpr \w+ {key} = )[^;]+;",
            lambda m, v=value: f"{m.group(1)}{v};", text, flags=re.M)
        assert n == 1, (name, key)
    f.write_text(text)
    return d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--chain-rows", type=int, default=4096)
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--fold-bits", type=int, default=24)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.hash import Sha256
    from fss_tpu_torch.ops import sha256_cuda, vdpf_cuda
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import vdpf as plain_vdpf

    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    max_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def words(shape, bits=32):
        return blk.words(rng.integers(0, 2**bits, size=shape,
                                      dtype=np.uint64), dev)

    ring = sha256_cuda.CHAIN_RING
    n_rows, n_chain = 1 << args.log2_rows, args.chain_rows
    cs = words((4, 4))
    pts = {n: words((n, 4, 4)) for n in (0, 1, ring - 1, ring, ring + 1,
                                         n_chain)}
    msg, a, b = words((n_rows, 4, 4)), words((n_rows, 4)), words((n_rows, 4))
    fold_pts = words((1 << args.fold_bits, 4, 4))
    sha = Sha256(SHA_KEY)
    prg = ChaCha(2, NONCE)
    s0, xs = words((n_rows, 4)), words((n_rows,), 16)
    vcws = words((n_rows, 16, 8))
    vcws[:, :, 5:] = 0  # the VDPF's level rows: 5 words of CW, then zeros
    vev = (s0, vcws, xs, 16, 0, prg, sha)

    calls = {
        "chain": lambda: sha256_cuda.chain(SHA_KEY, pts[n_chain], cs),
        "hash64": lambda: sha256_cuda.hash64(SHA_KEY, msg),
        "xor_hash": lambda: sha256_cuda.xor_hash(SHA_KEY, a, b),
        "tree_fold": lambda: vdpf_cuda.fold(sha, fold_pts, cs, "tree")}
    refs = {f"chain{n}": sha256_cuda.chain_plain(SHA_KEY, p, cs)
            for n, p in pts.items()}
    refs["hash64"] = sha256_cuda.hash64_plain(SHA_KEY, msg)
    refs["xor_hash"] = sha256_cuda.xor_hash_plain(SHA_KEY, a, b)
    refs["vdpf_eval"] = vdpf_cuda.eval_packed_plain(*vev)
    refs["tree_fold"] = plain_vdpf.fold(
        lambda m: sha256_cuda.hash64_plain(SHA_KEY, m), fold_pts, cs,
        "tree")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # Every variant's libraries, built at once.
    port_csrc = _build.CSRC
    trees = []  # (name, csrc, sources)
    if args.parent:
        trees.append(("parent", args.parent / "fss_tpu_torch" / "csrc",
                      ("sha256", "vdpf_eval")))
    trees.append(("port", port_csrc, ("sha256", "vdpf_eval")))
    for name, choices in VARIANTS.items():
        trees.append((name, patch(port_csrc, name, choices), ("sha256",)))
    order = trees + trees[:2][::-1] if args.parent else (
        trees + trees[:1])
    jobs = []
    for name, csrc, sources in trees:
        out = REPO / "build" / ("fss_tpu_torch_hash_"
                                + name.replace("/", "_"))
        out.mkdir(parents=True, exist_ok=True)
        _build.CSRC, _build.BUILD_DIR = csrc, out
        for f in sources:
            so = _build.library(f)
            jobs.append((name, f, so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(csrc / f"{f}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for name, f, so, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {f}:\n{text}")
        libs[name, f], logs[name, f] = so, text
    _build.CSRC, _build.BUILD_DIR = port_csrc, _build.BUILD_DIR
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")

    def clocks_under(fn, seconds=1.5):
        """nvidia-smi's SM clock (MHz) and power draw (W), sampled every
        100 ms while ``fn`` runs back to back for ``seconds``: the
        samples' medians."""
        fn()
        torch.cuda.synchronize()
        smi_loop = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        smi_loop.terminate()
        out, _ = smi_loop.communicate(timeout=30)
        rows = [[float(x) for x in line.split(",")]
                for line in out.splitlines()[2:] if line.strip()]
        return {"samples": len(rows),
                "sm_mhz": float(np.median([r[0] for r in rows])),
                "power_w": float(np.median([r[1] for r in rows]))}

    done = set()
    for name, csrc, sources in order:
        row = {"variant": name, "card": smi}
        for f in sources:
            _build._libs[f] = ctypes.CDLL(str(libs[name, f]))
        checks = {f"chain{n}": sha256_cuda.chain(SHA_KEY, p, cs)
                  for n, p in pts.items()}
        checks["hash64"] = calls["hash64"]()
        checks["xor_hash"] = calls["xor_hash"]()
        checks["tree_fold"] = calls["tree_fold"]()
        if "vdpf_eval" in sources:
            checks["vdpf_eval"] = vdpf_cuda.eval_packed(*vev)
        torch.cuda.synchronize()
        bad = [k for k, v in checks.items() if not all(
            torch.equal(x, y) for x, y in zip(
                v if isinstance(v, tuple) else (v,),
                refs[k] if isinstance(refs[k], tuple) else (refs[k],)))]
        row["mismatches"] = bad
        if bad:
            print(json.dumps(row), flush=True)
            continue
        ms = {k: cuda_ms(fn, 5 if k in ("chain", "tree_fold")
                         else args.reps) for k, fn in calls.items()}
        if "vdpf_eval" in sources:
            ms["vdpf_eval"] = cuda_ms(
                lambda: vdpf_cuda.eval_packed(*vev), args.reps)
        row["ms"] = ms
        row["chain_clocks_per_row"] = ms["chain"] * max_mhz * 1e3 / n_chain
        row["ptxas"] = {
            k: v for k, v in chip_smoke.ptxas_usage(
                logs[name, "sha256"]).items()
            if "chain" in k or "hash64" in k}
        row["sass"] = {
            k: v for k, v in chip_smoke.sass_usage(
                cuobjdump, libs[name, "sha256"], pipes=True).items()
            if "chain" in k or "hash64" in k}
        if name == "port" or name.startswith("chain/"):
            row["sass_chain_roles"] = {
                k: v for k, v in chip_smoke.chain_role_usage(
                    _build.nvcc(), cuobjdump, csrc,
                    libs[name, "sha256"].parent).items() if "role" in k}
        if name == "port" and "clocks" not in done:
            done.add("clocks")
            row["sm_clock_mhz_under_load"] = {
                k: clocks_under(calls[k]) for k in ("hash64", "chain")}
        row["sass_fields"] = ["instructions", "alu", "lds", "alu_pipe",
                              "imad", "viadd"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
