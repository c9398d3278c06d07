#!/usr/bin/env python3
"""The AES Gen kernels' designs against each other, on one GPU.

    python3 scripts/torch_aes_gen_variants.py [--log2-keys 20] [--bits 16]
        [--reps 10] [--others] [--port-only] [--repo DIR]

Times B-17 (``dpf_gen_aes``: ``dpf_cuda.gen_packed`` with betas and
Uint(32), the kernel of ``Dpf.gen_batch``) and B-18 (``dcf_gen_aes``:
``dcf_cuda.gen_packed``, lt, Uint(32)) with AES-128-MMO keyed as the JAX
bench (``bytes(range(16 i, 16 (i + 1)))``) at 2^log2-keys keys of
``--bits`` bits, under each AES table layout (``csrc/aes.cuh``:
AesTables <32, 1> copies of Te0, <32, 2> copies of Te0 and Te2; and <1, 1>
one table and <16, 1> copies of Te0, which the port does not use and the
patched copies get from ``OLD_TABLES``) and each split of the parties
(``csrc/parties.cuh``, ``kGenParties``: ``key``, one thread runs both;
``party``, two lanes a key) with 128-thread CTAs, then <32, 2> with 256 and 512, then
the port's design again (the first and last bound the drift). Each
variant, the port's own too, is a copy of ``csrc/`` under ``build/``,
patched where it differs; its outputs are held byte-exact against the
port's plain versions (computed once) before it is timed with CUDA
events. Each variant's line carries, per kernel (the AES, Uint(32)
instantiation), ptxas's registers and spill stores, the static and
dynamic shared memory
a CTA and its CTAs per SM (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a small library
that includes the patched source).

``--others`` times the other AES kernels (B-14 ``dpf_eval``, B-15
``ht_eval``, B-16 ``dcf_eval``, the Half-Tree Gen, the VDPF eval with
SHA-256, the DPF, DCF and Half-Tree EvalAll at 24 bits) under the
layouts <1, 1>, <32, 1> and <32, 2>, then the same three in the other
order, each held against its plain version.

``--port-only`` times the port's own AES kernels and both Gen calls with
each PRG, with no variants, and prints a digest of every output:
``--repo DIR`` takes the ``fss_tpu_torch`` of another checkout (e.g. the
parent, unpacked under ``build/``), so two trees compare in one call on
one card (parent, change, change, parent) and their outputs are seen to
be the same bytes. A variant that cannot launch (a CTA needing more
registers than an SM has) shows its launch error.

One JSON line a variant, after the card's name and power limit
(nvidia-smi). Without a card the script exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
AES_KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
LAYOUTS = {"table1": (1, 1), "copies16": (16, 1), "copies32": (32, 1),
           "copies32x2": (32, 2)}
GENS = ("dpf_gen", "dcf_gen")
OTHERS = ("dpf_eval", "dcf_eval", "ht_eval", "ht_gen", "ht_eval_all",
          "vdpf_eval", "dpf_eval_all", "dcf_eval_all")
# The AES, Uint(32) (kWrap) instantiation of each Gen kernel.
OCC_SRC = """#include "{src}.cu"
extern "C" int fss_occupancy(int* out) {{
  using Prg = fss::AesPrg<{mul}, AesTables>;
  auto kernel = {kernel}<fss::kWrap, fss::kGenParties<Prg>, Prg>;
  int rc = fss::allow_smem(kernel, fss::kPrgSmem<Prg>);
  cudaFuncAttributes a;
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&a, kernel);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], kernel, fss::kGenThreads<Prg>, fss::kPrgSmem<Prg>);
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = fss::kPrgSmem<Prg>;
  out[4] = fss::kGenThreads<Prg>;
  return rc;
}}
"""

# aes.cuh's AesTables as it was when the variants were chosen: besides the
# port's <32, 1> and <32, 2>, <1, 1> (one Te0, static, no copies) and
# <16, 1> (16 copies, lane l reading copy l % 16).
OLD_TABLES = """template <int COPIES, int TABLES>
struct AesTables {
  static_assert((TABLES == 1 && (COPIES == 1 || COPIES == 16 ||
                                 COPIES == 32)) ||
                    (TABLES == 2 && COPIES == 32),
                "AesTables: <1, 1>, <16, 1>, <32, 1> or <32, 2>");
  static constexpr int kTables = TABLES;
  // log2 of the bytes between entries i and i + 1 of a table.
  static constexpr int kShift = COPIES == 1    ? 2
                                : COPIES == 16 ? 6
                                : TABLES == 1  ? 7
                                               : 8;
  // Dynamic shared memory the tables take.
  static constexpr int kBytes = COPIES == 1 ? 0 : 256 << kShift;

  // Every thread of the block, then a barrier: the single table, then
  // (COPIES > 1) the copies from it, neighbouring threads storing
  // neighbouring 16 bytes.
  __device__ static void fill() {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      aes_te0[i] = aes_te0_entry(i);
    __syncthreads();
    if constexpr (COPIES > 1) {
      constexpr int kVecs = COPIES * TABLES / 4;  // 16-byte stores an entry
#pragma unroll 4
      for (int j = threadIdx.x; j < 256 * kVecs; j += blockDim.x) {
        const uint32_t e = aes_te0[j / kVecs];
        const uint32_t v = (j % kVecs) * 4 < COPIES ? e : aes_rotr(e, 16);
        aes_smem[j] = make_uint4(v, v, v, v);
      }
      __syncthreads();
    }
  }

  // This thread's byte offset into table j (0: Te0, 1: Te2).
  __device__ static uint32_t offset(int j) {
    return COPIES == 1 ? 0u : ((threadIdx.x % COPIES) + j * COPIES) * 4u;
  }

  // The entry of byte K of x, in the table at this thread's offset `off`.
  template <int K>
  __device__ static uint32_t load(uint32_t x, uint32_t off) {
    uint32_t a;
    if constexpr (kShift == 8) {
      a = __byte_perm(x, off, 0x5504 | (K << 4));
    } else if constexpr (8 * K >= kShift) {
      a = ((x >> (8 * K - kShift)) & (0xFFu << kShift)) | off;
    } else {
      a = ((x << (kShift - 8 * K)) & (0xFFu << kShift)) | off;
    }
    const char* base;
    if constexpr (COPIES == 1) {
      base = reinterpret_cast<const char*>(aes_te0);
    } else {
      base = reinterpret_cast<const char*>(aes_smem);
    }
    return *reinterpret_cast<const uint32_t*>(base + a);
  }
};
"""


def patch(src: pathlib.Path, name: str, files, layout=None, parties=None,
          threads=None) -> pathlib.Path:
    """A copy of csrc/ under build/ with ``files``' AES layout, and the Gens'
    parties (1 or 2 a thread) and CTA size, replaced where given; a layout
    of fewer than 32 copies brings ``OLD_TABLES`` into its aes.cuh."""
    d = REPO / "build" / f"csrc_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    edits = {f"{f}.cu": [] for f in files}
    if layout is not None:
        for f in files:
            edits[f"{f}.cu"].append((
                r"using AesTables = fss::AesTables<\d+, \d>;",
                f"using AesTables = fss::AesTables<{layout[0]}, "
                f"{layout[1]}>;"))
        if layout[0] != 32:
            edits["aes.cuh"] = [(r"template <int COPIES, int TABLES>\n"
                                 r"struct AesTables \{.*?\n\};\n",
                                 OLD_TABLES)]
    edits["parties.cuh"] = []
    if parties is not None:
        edits["parties.cuh"].append((
            r"constexpr int kGenParties<AesPrg<MUL, T>> = \d;",
            f"constexpr int kGenParties<AesPrg<MUL, T>> = {parties};"))
    if threads is not None:
        edits["parties.cuh"].append((
            r"constexpr int kGenThreads<AesPrg<MUL, T>> = \d+;",
            f"constexpr int kGenThreads<AesPrg<MUL, T>> = {threads};"))
    for fname, subs in edits.items():
        text = (d / fname).read_text()
        for old, new in subs:
            text, n = re.subn(old, lambda m, new=new: new, text,
                              flags=re.S)
            assert n == 1, (fname, old)
        (d / fname).write_text(text)
    return d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-keys", type=int, default=20)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--eval-all-bits", type=int, default=24)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--others", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--repo", type=pathlib.Path, default=REPO)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.repo.resolve()))
    from fss_tpu_torch import _build, groups
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.hash import Sha256
    from fss_tpu_torch.ops import (dcf_cuda, dpf_cuda, eval_all_cuda,
                                   ht_cuda, vdpf_cuda)
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import dcf, dpf, half_tree_dpf

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)

    def words(shape, bits=32):
        return blk.words(rng.integers(0, 2**bits, size=shape,
                                      dtype=np.uint64), dev)

    n, nkeys, n_ea = args.bits, 1 << args.log2_keys, args.eval_all_bits
    g = groups.Uint(32)
    aes = {m: AesMmo(m, AES_KEYS[:m]) for m in (1, 2, 4)}
    cha = {m: ChaCha(m, NONCE) for m in (2, 4)}
    hk = (0x01234567, 0x89ABCDEF, 0x0F1E2D3C, 0x4B5A6978)
    sha = Sha256((0xA1B2C3D4, 0x11223344, 0x55667788, 0x99AABBCC))
    s0s, betas = words((nkeys, 2, 4)), words((nkeys, 4))
    alphas = words((nkeys,), n)
    xs = alphas.clone()
    xs[1::2] ^= 1
    s0 = s0s[:, 0].contiguous()
    ea_s0s, ea_beta = words((1, 2, 4)), words((1, 4))
    ea_alpha = blk.pack_inputs([int(rng.integers(0, 2**n_ea))], n_ea, dev)
    wire = dpf.gen(aes[2], g, n, s0s, blk.pack_inputs(alphas, n), betas)
    dwire = dcf.gen(aes[4], g, n, "lt", s0s, blk.pack_inputs(alphas, n),
                    betas)
    hwire, _ = half_tree_dpf.gen(aes[1], g, n, blk.words(list(hk), dev), s0s,
                                 blk.pack_inputs(alphas, n), betas)
    vcws = dpf_cuda.gen_packed_plain(s0s, alphas, n, aes[2],
                                     ocw_row=False)[0]
    ea_key = dpf.gen(aes[2], g, n_ea, ea_s0s, ea_alpha, ea_beta)[0]
    ea_dkey = dcf.gen(aes[4], g, n_ea, "lt", ea_s0s, ea_alpha, ea_beta)[0]
    ea_hkey = [k[0] for k in half_tree_dpf.gen(
        aes[1], g, n_ea, blk.words(list(hk), dev), ea_s0s, ea_alpha,
        ea_beta)]
    ea_seed = ea_s0s[0, 0].contiguous()

    def gen_calls(P):
        """B-17's and B-18's calls: (kernel, plain) pairs."""
        dargs = (s0s, alphas, n, P[2])
        cargs = (s0s, alphas, betas, n, P[4], "lt", g)
        return {
            "dpf_gen": (lambda: dpf_cuda.gen_packed(
                *dargs, betas=betas, group=g), lambda: dpf_cuda.
                gen_packed_plain(*dargs, betas=betas, group=g)),
            "dcf_gen": (lambda: dcf_cuda.gen_packed(*cargs),
                        lambda: dcf_cuda.gen_packed_plain(*cargs))}

    def other_calls():
        """The other AES kernels: (kernel, plain) pairs."""
        ev = (s0, wire, xs, n, 0, aes[2])
        cev = (s0, dwire, xs, n, 0, aes[4], "wrap")
        hev = (s0, hwire, xs, n, 0, aes[1], hk)
        hgv = (s0s, alphas, n, aes[1], hk)
        vev = (s0, vcws, xs, n, 0, aes[2], sha)
        ea = (aes[2], g, n_ea, 0, ea_seed, ea_key)
        dea = (aes[4], g, n_ea, 0, ea_seed, ea_dkey)
        hea = (aes[1], g, n_ea, 0, hk, ea_seed, *ea_hkey)
        return {
            "dpf_eval": (lambda: dpf_cuda.eval_packed(*ev),
                         lambda: dpf_cuda.eval_packed_plain(*ev)),
            "dcf_eval": (lambda: dcf_cuda.eval_packed(*cev),
                         lambda: dcf_cuda.eval_packed_plain(*cev)),
            "ht_eval": (lambda: ht_cuda.eval_packed(*hev),
                        lambda: ht_cuda.eval_packed_plain(*hev)),
            "ht_gen": (lambda: ht_cuda.gen_packed(*hgv),
                       lambda: ht_cuda.gen_packed_plain(*hgv)),
            "vdpf_eval": (lambda: vdpf_cuda.eval_packed(*vev),
                          lambda: vdpf_cuda.eval_packed_plain(*vev)),
            "dpf_eval_all": (lambda: eval_all_cuda.eval_all(*ea),
                             lambda: eval_all_cuda.eval_all_plain(*ea)),
            "dcf_eval_all": (lambda: eval_all_cuda.dcf_eval_all(*dea),
                             lambda: eval_all_cuda.dcf_eval_all_plain(*dea)),
            "ht_eval_all": (lambda: eval_all_cuda.ht_eval_all(*hea),
                            lambda: eval_all_cuda.ht_eval_all_plain(*hea))}

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def flat(out):
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in flat(o)]
        return [out]

    def same(a, b):
        return all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(flat(a), flat(b)))

    def digest(out):
        h = hashlib.sha256()
        for t in flat(out):
            h.update(blk.to_numpy(t).tobytes())
        return h.hexdigest()[:16]

    if args.port_only:
        # The same calls in every tree: the Gens without the output CW (the
        # parent's kernels had none) and Dpf.gen_batch's whole call.
        row = {"repo": str(args.repo), "ms": {}, "digest": {}}
        for tag, P in (("", cha), ("_aes", aes)):
            calls = {
                "dpf_gen": lambda P=P: dpf_cuda.gen_packed(s0s, alphas, n,
                                                           P[2]),
                "dpf_gen_batch": lambda P=P: dpf_cuda.gen_batch(
                    P[2], g, n, s0s, alphas, betas),
                "dcf_gen": gen_calls(P)["dcf_gen"][0]}
            if tag:
                calls.update({k: v[0] for k, v in other_calls().items()})
            for name, fn in calls.items():
                row["digest"][name + tag] = digest(fn())
                row["ms"][name + tag] = cuda_ms(fn)
        print(json.dumps(row), flush=True)
        return 0

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.build()
    port_libs, port_logs = dict(_build._libs), dict(_build._logs)
    variants = []  # (name, files, patch kwargs, calls)
    port = ("port", GENS, {})  # an unpatched copy
    for lname, layout in LAYOUTS.items():
        for pname, parties in (("key", 2), ("party", 1)):
            variants.append((f"{lname}/{pname}/t128", GENS,
                             dict(layout=layout, parties=parties,
                                  threads=128)))
    for pname, parties in (("key", 2), ("party", 1)):
        for threads in (256, 512):
            variants.append((f"copies32x2/{pname}/t{threads}", GENS,
                             dict(layout=(32, 2), parties=parties,
                                  threads=threads)))
    variants = [port, *variants, port]
    if args.others:
        others = [(f"others/{lname}", OTHERS, dict(layout=LAYOUTS[lname]))
                  for lname in ("table1", "copies32", "copies32x2")]
        variants += others + others[::-1]

    # Build every variant's sources and occupancy libraries at once.
    dirs, jobs = {}, []
    for name, files, kw in variants:
        if name in dirs:
            continue
        d = dirs[name] = patch(csrc, name.replace("/", "_"), files, **kw)
        out = REPO / "build" / f"fss_tpu_torch_{d.name}"
        out.mkdir(parents=True, exist_ok=True)
        _build.CSRC, _build.BUILD_DIR = d, out
        for f in files:
            so = _build.library(f)
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                   str(d / f"{f}.cu")]
            jobs.append((f, so.with_suffix(".log"), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for f in set(files) & set(GENS):
            occ = d / f"occ_{f}.cu"
            occ.write_text(OCC_SRC.format(
                src=f, mul=2 if f == "dpf_gen" else 4, kernel=f"{f}_kernel"))
            jobs.append((f, None, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(d / f"occ_{f}.so"), str(occ)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for f, log, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {f}:\n{text}")
        if log is not None:
            log.write_text(text)

    def ptxas(log: str, src: str) -> dict:
        """Registers and spill stores of the AES wrap-mode Gen kernel."""
        for chunk in log.split("Compiling entry function '")[1:]:
            name = chunk.split("'", 1)[0]
            if f"{src}_kernelILi1E" in name and "AesPrg" in name:
                regs = re.search(r"Used (\d+) registers", chunk)
                spill = re.search(r"(\d+) bytes spill stores", chunk)
                return {"registers": int(regs.group(1)),
                        "spill_bytes": int(spill.group(1))}
        return {}

    gen_ref = {k: plain() for k, (_, plain) in gen_calls(aes).items()}
    other_ref = ({k: plain() for k, (_, plain) in other_calls().items()}
                 if args.others else {})
    for name, files, _ in variants:
        d = dirs[name]
        _build.CSRC = d
        _build.BUILD_DIR = REPO / "build" / f"fss_tpu_torch_{d.name}"
        _build._libs = {k: v for k, v in port_libs.items() if k not in files}
        _build._logs = {k: v for k, v in port_logs.items() if k not in files}
        logs = _build.build()
        row = {"variant": name}
        calls, refs = ((gen_calls(aes), gen_ref) if files == GENS else
                       (other_calls(), other_ref))
        for k, (fn, _) in calls.items():
            try:
                ok = same(fn(), refs[k])
            except RuntimeError as e:  # e.g. too many registers a CTA
                row[k] = {"launch_error": str(e)}
                continue
            row[k] = {"same_as_plain": ok,
                      "ms": cuda_ms(fn) if ok else None}
            if k in GENS:
                row[k].update(ptxas(logs[k], k))
                occ = (ctypes.c_int * 5)()
                rc = ctypes.CDLL(str(d / f"occ_{k}.so")).fss_occupancy(occ)
                row[k].update(dict(zip(
                    ("ctas_per_sm", "registers_attr", "static_smem",
                     "dynamic_smem", "threads"), list(occ))),
                              occupancy_rc=rc)
        print(json.dumps(row), flush=True)
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    _build._libs, _build._logs = port_libs, port_logs
    return 0


if __name__ == "__main__":
    sys.exit(main())
