#!/usr/bin/env python3
"""The hash kernels' designs against each other and the parent's, on one
GPU: the flat proof chains (BLAKE3 and SHA-256), SHA-256's H' and the
SHA-256 XorHash (B-12).

    python3 scripts/torch_hash_variants.py [--parent DIR] [--only PREFIX]
        [--chain-rows 4096] [--log2-rows 20] [--fold-bits 24] [--reps 10]

Times, for each variant of ``csrc/blake3.cu`` or ``csrc/sha256.cu``:

  b3chain    ``blake3_cuda.chain`` (the VDPF's flat proof) on
             ``--chain-rows`` points, ms and clocks a row at the card's
             max SM clock;
  chain      ``sha256_cuda.chain``, the same;
  hash64     ``sha256_cuda.hash64`` on 2^log2-rows rows;
  xor_hash   ``sha256_cuda.xor_hash`` (B-12) on 2^log2-rows rows whose
             points are below 2^32 (lanes 1-3 zero but for the domain bit,
             as on every main path), and ``xor_hash_wide`` on random
             128-bit points;
  tree_fold  ``vdpf_cuda.fold(Sha256, ..., "tree")`` over 2^fold-bits rows
             (the SHA-256 VDPF EvalAll's fold: one hash64 launch a level);

and, for the parent's tree and the port's, ``vdpf_eval`` with SHA-256
(2^log2-rows keys, 16 bits) and the entry points the hash kernels feed,
keyed with BLAKE3 and with SHA-256 (ChaCha mul=2, ``Uint(32)``):
``Vdpf.gen_batch`` of 2^log2-rows keys from a numpy seed and
``Vdpf.eval_all`` (tree fold) at 20 and 24 bits, their outputs held equal
across the trees. The variants are copies of ``csrc/`` under
``build/`` with the design choices at the top of one source patched
(``source_of``): the BLAKE3 chain's lanes a compression
(``kChainLanes``: 1 is one lane fed by the ring), its ring (``kRing``) and
how the message words reach the lanes (``kShflWords``: shuffles, or
shared memory); B-12's shared prefix (``kXorShared``; without it each
compression runs from the key's midstate), its adds (``XorAdd``,
``XorSchedAdd``: ``PlainAdd``
IADD3s, ``FmaAdd`` IMADs, ``MixedAdd`` both, ``csrc/sha256.cuh``) and CTA
(``kXorThreads``); the SHA-256 chain's and hash64's choices as before
(``ChainAdd``, ``H64Add``, ``H64SchedAdd``, ``kChainHelper``,
``kPieces``, ``kSelfWords``, ``kRing``, ``kH64Threads``, ``kH64Rows``).
``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive``
unpacked under ``build/``) adds its ``csrc/`` first and last, and the
port's design runs second and second to last, so the drift is bounded and
the parent and the change compare in one call; ``--only`` keeps the
variants whose name starts with it. Each variant's outputs are held
byte-exact against the plain versions (computed once: the chains at 0, 1,
2, around both rings' sizes, ``--chain-rows`` points and, BLAKE3's, on
rows at a 4-byte offset; hash64 on all rows; B-12 on small, wide and
mixed points, at a 4-byte offset and N off the CTA's multiple; the
fold's proof; vdpf_eval's outputs) before it is timed with CUDA events.
Each line carries ptxas's registers of the changed source's hash kernels
and their SASS counts split by pipe (``chip_smoke.sass_usage``), the
chains' roles and one row of B-12
(``chip_smoke.chain_role_usage``), and the port's first line the SM clock
and power draw under a sustained loop of each timed kernel (nvidia-smi,
every 100 ms, the first two samples left out) and one lane's dependent
instruction latencies (``chip_smoke.alu_latencies``). One JSON line a
variant, after the card's name and power limit (nvidia-smi). Without a
card the script exits 1 and prints nothing.
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
B3_IV = (0x11111111, 0x22222222, 0x33333333, 0x44444444, 0x55555555,
         0x66666666, 0x77777777, 0x88888888)
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
SOURCES = ("blake3", "sha256", "vdpf_eval")
# name -> the choices patched into its source (source_of) (a regex of the
# line's start -> its new value).
VARIANTS = {
    "b3chain/lanes1": {"kChainLanes": "1", "kShflWords": "false"},
    "b3chain/lanes2": {"kChainLanes": "2", "kShflWords": "false"},
    "b3chain/smem-words": {"kShflWords": "false"},
    "b3chain/ring4": {"kRing": "4"},
    "b3chain/ring16": {"kRing": "16"},
    "xor/mid-only": {"kXorShared": "false"},
    "xor/plain-adds": {"XorAdd": "fss::PlainAdd"},
    "xor/fma-adds": {"XorSchedAdd": "fss::FmaAdd"},
    "xor/mixed-adds": {"XorAdd": "fss::MixedAdd",
                       "XorSchedAdd": "fss::MixedAdd"},
    "xor/t256": {"kXorThreads": "256"},
    "chain/self0-pieces12": {"kSelfWords": "0", "kPieces": "12"},
    "chain/self8-pieces5": {"kPieces": "5"},
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


def source_of(name: str) -> str:
    """The source whose choices variant ``name`` patches."""
    return "blake3" if name.startswith("b3chain/") else "sha256"


def patch(src: pathlib.Path, name: str, choices: dict,
          root: pathlib.Path = REPO / "build") -> pathlib.Path:
    """A copy of csrc/ under ``root`` with the choices patched into
    ``source_of(name)``.cu."""
    d = root / f"csrc_hash_{name.replace('/', '_')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    f = d / f"{source_of(name)}.cu"
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
    ap.add_argument("--only", default="")
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
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Vdpf
    from fss_tpu_torch.hash import Blake3, Sha256
    from fss_tpu_torch.ops import blake3_cuda, sha256_cuda, vdpf_cuda
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

    def small_points(a, every=1):
        """Lanes 1-3 of a zero but for the domain bit on every
        ``every``-th row, in place; a."""
        a[::every, 1:3] = 0
        a[::every, 3] &= 1
        return a

    n_rows, n_chain = 1 << args.log2_rows, args.chain_rows
    cs = words((4, 4))
    chain_ns = sorted({0, 1, 2, n_chain} | {
        r + d for r in (4, blake3_cuda.CHAIN_RING, sha256_cuda.CHAIN_RING)
        for d in (-1, 0, 1)})
    flat = words((16 * n_chain + 1,))
    pts = {n: flat[:16 * n].view(n, 4, 4) for n in chain_ns}
    b3_odd = flat[1:16 * 37 + 1].view(37, 4, 4)  # a 4-byte offset
    msg, b = words((n_rows, 4, 4)), words((n_rows, 4))
    a_wide = words((n_rows, 4))
    a_small = small_points(a_wide.clone())
    xor_edge = []  # (a, b): N = 1 and off the CTA, mixed, offset views
    for rows in (1, 130, 4133):
        for every in (0, 1, 7):  # wide, small, mixed
            for off in (0, 1):
                ab = words((2, 4 * rows + 1))
                x, y = (ab[i, off:off + 4 * rows].view(rows, 4)
                        for i in (0, 1))
                xor_edge.append((small_points(x, every) if every else x, y))
    fold_pts = words((1 << args.fold_bits, 4, 4))
    sha = Sha256(SHA_KEY)
    prg = ChaCha(2, NONCE)
    s0, xs = words((n_rows, 4)), words((n_rows,), 16)
    vcws = words((n_rows, 16, 8))
    vcws[:, :, 5:] = 0  # the VDPF's level rows: 5 words of CW, then zeros
    vev = (s0, vcws, xs, 16, 0, prg, sha)
    # The entry points the hash kernels feed: name -> (Vdpf of 16 bits,
    # {bits: (Vdpf, key)}); the keys come later, from the port's kernels.
    vdpfs = {name: Vdpf(16, groups.Uint(32), prg, hashes=h)
             for name, h in (("blake3", Blake3(B3_IV)), ("sha256", sha))}
    v_alphas, v_betas = words((n_rows,), 16), words((n_rows, 4))
    ea_bits = (20, 24)

    calls = {
        "b3chain": lambda: blake3_cuda.chain(B3_IV, pts[n_chain], cs),
        "chain": lambda: sha256_cuda.chain(SHA_KEY, pts[n_chain], cs),
        "hash64": lambda: sha256_cuda.hash64(SHA_KEY, msg),
        "xor_hash": lambda: sha256_cuda.xor_hash(SHA_KEY, a_small, b),
        "xor_hash_wide": lambda: sha256_cuda.xor_hash(SHA_KEY, a_wide, b),
        "tree_fold": lambda: vdpf_cuda.fold(sha, fold_pts, cs, "tree")}

    def outputs(vdpf: bool) -> dict:
        """Every checked output of the loaded libraries (or, before any
        is loaded, of the plain versions: ``plain``)."""
        out = {}
        for n, p in pts.items():
            out[f"b3chain{n}"] = b3(B3_IV, p, cs)
            out[f"chain{n}"] = s2(SHA_KEY, p, cs)
        out["b3chain_offset"] = b3(B3_IV, b3_odd, cs)
        out["hash64"] = h64(SHA_KEY, msg)
        for i, (x, y) in enumerate([(a_small, b), (a_wide, b)]
                                   + xor_edge):
            out[f"xor_hash{i}"] = xh(SHA_KEY, x, y)
        out["tree_fold"] = fold(fold_pts)
        if vdpf:
            out["vdpf_eval"] = ve(*vev)
        return out

    b3, s2 = blake3_cuda.chain_plain, sha256_cuda.chain_plain
    h64, xh = sha256_cuda.hash64_plain, sha256_cuda.xor_hash_plain
    fold = lambda p: plain_vdpf.fold(  # noqa: E731
        lambda m: sha256_cuda.hash64_plain(SHA_KEY, m), p, cs, "tree")
    ve = vdpf_cuda.eval_packed_plain
    refs = outputs(True)
    b3, s2 = blake3_cuda.chain, sha256_cuda.chain
    h64, xh = sha256_cuda.hash64, sha256_cuda.xor_hash
    fold = lambda p: vdpf_cuda.fold(sha, p, cs, "tree")  # noqa: E731
    ve = vdpf_cuda.eval_packed

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

    # The port's libraries (a tree's own hash sources replace them below);
    # the EvalAll keys, from them.
    _build.build()
    ea = {name: {n: (Vdpf(n, groups.Uint(32), prg, hashes=d.hashes),)
                 for n in ea_bits} for name, d in vdpfs.items()}
    for name, by_bits in ea.items():
        for n, (d,) in by_bits.items():
            by_bits[n] = (d, d.gen_retry(np.random.default_rng(8),
                                         (1 << n) // 3, v_betas[0]))

    def entry_calls():
        """name -> a call of an entry point the hash kernels feed."""
        out = {}
        for name, d in vdpfs.items():
            out[f"{name}_gen_batch"] = (
                lambda d=d: d.gen_batch(np.random.default_rng(7), v_alphas,
                                        v_betas))
            for n, (e, k) in ea[name].items():
                out[f"{name}_eval_all_{n}"] = (
                    lambda e=e, k=k: e.eval_all(0, k[0][0], *k[1:],
                                                fold="tree"))
        return out

    entry_refs = {}  # the first tree's outputs

    # Every variant's libraries, built at once.
    port_csrc = _build.CSRC
    trees = []  # (name, csrc, sources)
    if args.parent:
        trees.append(("parent", args.parent / "fss_tpu_torch" / "csrc",
                      SOURCES))
    trees.append(("port", port_csrc, SOURCES))
    for name, choices in VARIANTS.items():
        if name.startswith(args.only):
            trees.append((name, patch(port_csrc, name, choices),
                          (source_of(name),)))
    order = trees + trees[:2][::-1] if args.parent else (
        trees + trees[:1])
    jobs = []
    for name, csrc, sources in trees:
        out = REPO / "build" / ("fss_tpu_torch_hash_"
                                + name.replace("/", "_"))
        out.mkdir(parents=True, exist_ok=True)
        for f in sources:
            so = out / f"{f}.so"  # no digest: the parent's headers differ
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
        for f in SOURCES:  # the tree's sources, the port's for the rest
            _build._libs[f] = ctypes.CDLL(str(
                libs.get((name, f), libs["port", f])))
        checks = outputs("vdpf_eval" in sources)
        torch.cuda.synchronize()
        bad = [k for k, v in checks.items() if not all(
            torch.equal(x, y) for x, y in zip(
                v if isinstance(v, tuple) else (v,),
                refs[k] if isinstance(refs[k], tuple) else (refs[k],)))]
        row["mismatches"] = bad
        if bad:
            print(json.dumps(row), flush=True)
            continue
        ms = {k: cuda_ms(fn, 5 if k in ("b3chain", "chain", "tree_fold")
                         else args.reps) for k, fn in calls.items()}
        if "vdpf_eval" in sources:
            ms["vdpf_eval"] = cuda_ms(lambda: ve(*vev), args.reps)
            for k, fn in entry_calls().items():
                got = fn()
                torch.cuda.synchronize()
                want = entry_refs.setdefault(k, got)
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    bad.append(k)
                ms[k] = cuda_ms(fn, 3)
            if bad:
                row["mismatches"] = bad
                print(json.dumps(row), flush=True)
                continue
        row["ms"] = ms
        row["clocks_per_row"] = {
            k: ms[k] * max_mhz * 1e3 / n_chain for k in ("b3chain", "chain")}
        row["ptxas"], row["sass"] = {}, {}
        for f in sources:
            if f == "vdpf_eval":
                continue
            row["ptxas"].update({
                k: v for k, v in chip_smoke.ptxas_usage(
                    logs[name, f]).items()
                if any(s in k for s in ("chain", "hash64", "xor_hash"))})
            row["sass"].update({
                f"{f} {k}": v for k, v in chip_smoke.sass_usage(
                    cuobjdump, libs[name, f], pipes=True).items()
                if any(s in k for s in ("chain", "hash64", "xor_hash"))})
            roles = ((chip_smoke.BLAKE3_CHAIN_ROLES_SRC, "blake3_chain_roles")
                     if f == "blake3" else
                     (chip_smoke.CHAIN_ROLES_SRC, "sha256_chain_roles"))
            if name != "parent":
                row["sass"].update({
                    f"{f} {k}": v for k, v in chip_smoke.chain_role_usage(
                        _build.nvcc(), cuobjdump, csrc,
                        libs[name, f].parent, *roles).items()
                    if "role" in k or "row_kernel" in k})
        if name == "port" and "clocks" not in done:
            done.add("clocks")
            row["sm_clock_mhz_under_load"] = {
                k: clocks_under(calls[k]) for k in (
                    "b3chain", "chain", "hash64", "xor_hash")}
            row["latency_clocks"] = chip_smoke.alu_latencies(
                _build.nvcc(), cuobjdump, libs[name, "blake3"].parent)
        row["sass_fields"] = ["instructions", "alu", "lds", "alu_pipe",
                              "imad", "viadd", "ldg"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
