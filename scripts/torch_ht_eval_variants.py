#!/usr/bin/env python3
"""The AES Half-Tree Eval kernel's designs (B-15) against each other and
the parent's, on one GPU.

    python3 scripts/torch_ht_eval_variants.py [--parent DIR] [--only PREFIX]
        [--log2-keys 20] [--bits 16] [--reps 20]

Times, for each variant of ``csrc/ht_eval.cu``, at 2^log2-keys keys of
``--bits`` bits (a random CCR hash key, half the x at alpha, as
``chip_smoke.py``'s main path):

  ht_eval_aes            B-15, AES-128-MMO mul=1 keyed as the JAX bench,
                         on wire rows [B, n, 8] (a distinct key each);
  ht_eval_aes_broadcast  the same seeds and x on one broadcast key [n, 8]:
                         every lane reads the same row, so the gap to the
                         wire rows is what their loads cost;
  ht_eval                B-7, the ChaCha instantiation, on wire rows.

The port's design is ``csrc/ht_eval.cu``. The variants are copies of
``csrc/`` under ``build/`` whose ``ht_eval.cu`` is
``scripts/ht_eval_designs.cu`` (the same kernel and entry point with every
choice a constant) with the choices at its top patched (``design``): the
AES tables' layout (``AesTables`` <32, 1> or <32, 2>), wire rows through
the Tensor Memory Accelerator's ring (filled by a producer warp) or one
16-byte load a level (``kAesTmaRows``), the ring's slots (``kRing``), keys
a thread (``kAesKeys``), the threads of a CTA that walk keys
(``kAesThreads``) and x loaded once or once a level (``kAesXOnce``);
``ldg-t2-cta1024`` is the port's design.
``--parent DIR`` (a checkout of the parent commit, e.g. ``git archive``
unpacked under ``build/``) adds its ``ht_eval.cu`` (the same C entry
point; its kernel reads a row as four 4-byte loads) first and last, and
the port's design second and second to last, so the drift is bounded and
the parent and the change compare in one call; ``--only`` keeps the
variants whose name starts with it. Each variant is held byte-exact
against the plain version first (computed once: both PRGs, n = 1, 2, 16,
33 and 128, a batch off every CTA's multiple, wire rows, a broadcast key,
rows at a 4-byte offset, x as 1 or 4 lanes), then timed with CUDA events.
Each line carries the AES kernel's ptxas registers, its SASS counts split
by pipe (``chip_smoke.sass_usage``: all, ALU, LDS, ALU-pipe, IMAD,
VIADD, LDG; the level loop's body is one AES block of 160 LDS), and its
dynamic shared memory and CTAs an SM (``cudaFuncGetAttributes``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a small library
that includes the source).

The port's rows also time the DPF and DCF AES Eval kernels (B-14, B-16)
on wire rows and on one broadcast key; the parent's and the port's rows
time the Half-Tree Gen kernel alone and ``HalfTreeDpf.gen_batch``'s work
(the parent: its Gen kernel, then the output CW in torch; the port: one
launch) with both PRGs, and
``Vdpf.gen_batch`` (2^log2-keys keys, SHA-256, from a numpy seed) with
each tree's ``block.words``, and its staging of the seed draws alone,
their outputs held equal across the trees. One JSON line a tree, after
the card's name and power limit (nvidia-smi). Without a card the script
exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
AES_KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
SHA_KEY = (0xA1B2C3D4, 0x11223344, 0x55667788, 0x99AABBCC)


def design(tables=2, tma=True, ring=3, keys=1, threads=128, xonce=True):
    """The choices at the top of csrc/ht_eval.cu, as patch values."""
    return {"AesTables": f"fss::AesTables<32, {tables}>",
            "kAesTmaRows": str(tma).lower(), "kRing": str(ring),
            "kAesKeys": str(keys), "kAesThreads": str(threads),
            "kAesXOnce": str(xonce).lower()}


# name -> the choices patched into csrc/ht_eval.cu: ldg (one 16-byte load a
# level) or tma (the ring, filled by a producer warp), t1 or t2
# (AesTables<32, 1> or <32, 2>), then what differs from design()'s defaults.
VARIANTS = {
    "ldg-t1": design(tables=1, tma=False),
    "ldg-t1-xlevel": design(tables=1, tma=False, xonce=False),
    "ldg-t2": design(tma=False),
    "ldg-t2-cta256": design(tma=False, threads=256),
    "ldg-t2-cta256-xlevel": design(tma=False, threads=256, xonce=False),
    "ldg-t2-cta256-keys2": design(tma=False, threads=256, keys=2),
    "ldg-t2-cta512": design(tma=False, threads=512),
    "ldg-t2-cta512-keys2": design(tma=False, threads=512, keys=2),
    "ldg-t2-cta1024": design(tma=False, threads=1024),
    "tma-t1": design(tables=1),
    "tma-t2": design(),
    "tma-t2-ring2": design(ring=2),
    "tma-t2-ring4": design(ring=4),
    "tma-t2-cta256": design(threads=256),
    "tma-t2-cta256-ring2": design(threads=256, ring=2),
    "tma-t2-cta256-ring4": design(threads=256, ring=4),
    "tma-t2-keys2-ring2": design(keys=2, ring=2),
}

# Registers, shared memory and CTAs an SM of the AES kernel on wire rows.
OCC_SRC = """#include "ht_eval.cu"
extern "C" int fss_occupancy(int* out) {
  using Prg = fss::AesPrg<1, AesTables>;
%s
  int rc = fss::allow_smem(kernel, smem);
  cudaFuncAttributes a;
  if (rc == 0) rc = (int)cudaFuncGetAttributes(&a, kernel);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                            threads, smem);
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = threads;
  return rc;
}
"""
OCC_PORT = """  auto kernel = ht_eval_kernel<Prg>;
  const size_t smem = fss::kPrgSmem<Prg>;
  const int threads = HtDesign<Prg>::kThreads;"""
OCC_DESIGNS = """  constexpr bool kTma = HtDesign<Prg>::kTma;
  auto kernel = ht_eval_kernel<Prg, kTma>;
  const size_t smem = kHtSmem<Prg, kTma>;
  const int threads = kHtThreads<Prg, kTma>;"""
OCC_PARENT = """  auto kernel = ht_eval_kernel<Prg>;
  const size_t smem = fss::kPrgSmem<Prg>;
  const int threads = 128;"""
# The parent's fss_ht_gen: no betas; the two leaves out.
PARENT_GEN_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, *(ctypes.c_uint32,) * 4,
                   ctypes.c_void_p, ctypes.c_void_p)


def patch(src: pathlib.Path, name: str, choices: dict) -> pathlib.Path:
    """A copy of csrc/ under build/ whose ht_eval.cu is
    scripts/ht_eval_designs.cu with the choices patched in."""
    d = REPO / "build" / f"csrc_ht_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    f = d / "ht_eval.cu"
    text = (REPO / "scripts" / "ht_eval_designs.cu").read_text()
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
    ap.add_argument("--log2-keys", type=int, default=20)
    ap.add_argument("--bits", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from fss_tpu_torch import _build, groups
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.api import Vdpf
    from fss_tpu_torch.hash import Sha256
    from fss_tpu_torch.ops import dcf_cuda, dpf_cuda, ht_cuda
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import dcf, dpf, half_tree_dpf

    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)

    def words(shape, bits=32):
        return blk.words(rng.integers(0, 2**bits, size=shape,
                                      dtype=np.uint64), dev)

    n, nkeys = args.bits, 1 << args.log2_keys
    g = groups.Uint(32)
    aes = {m: AesMmo(m, AES_KEYS[:m]) for m in (1, 2, 4)}
    cha = ChaCha(1, NONCE)
    hk = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    hkb = blk.words(list(hk), dev)
    s0s, betas = words((nkeys, 2, 4)), words((nkeys, 4))
    alphas = words((nkeys,), n)
    xs = alphas.clone()
    xs[1::2] ^= 1 + words((nkeys // 2,), n - 1)  # != alpha
    s0 = s0s[:, 0].contiguous()
    a_lanes = blk.pack_inputs(alphas, n)
    wire = {"aes": half_tree_dpf.gen(aes[1], g, n, hkb, s0s, a_lanes,
                                     betas)[0],
            "chacha": half_tree_dpf.gen(cha, g, n, hkb, s0s, a_lanes,
                                        betas)[0]}
    dwire = dpf.gen(aes[2], g, n, s0s, a_lanes, betas)
    cwire = dcf.gen(aes[4], g, n, "lt", s0s, a_lanes, betas)
    calls = {
        "ht_eval_aes": (ht_cuda.eval_packed, (s0, wire["aes"], xs, n, 0,
                                              aes[1], hk)),
        "ht_eval_aes_broadcast": (ht_cuda.eval_packed, (
            s0, wire["aes"][0].contiguous(), xs, n, 0, aes[1], hk)),
        "ht_eval": (ht_cuda.eval_packed, (s0, wire["chacha"], xs, n, 0, cha,
                                          hk))}
    port_calls = {  # B-14 and B-16: the same code in both trees
        "dpf_eval_aes": (dpf_cuda.eval_packed, (s0, dwire, xs, n, 0,
                                                aes[2])),
        "dpf_eval_aes_broadcast": (dpf_cuda.eval_packed, (
            s0, dwire[0].contiguous(), xs, n, 0, aes[2])),
        "dcf_eval_aes": (dcf_cuda.eval_packed, (s0, cwire, xs, n, 0, aes[4],
                                                "wrap")),
        "dcf_eval_aes_broadcast": (dcf_cuda.eval_packed, (
            s0, cwire[0].contiguous(), xs, n, 0, aes[4], "wrap"))}

    # The checks: (PRG, args of eval_packed) on small batches.
    checks = []
    cb = 1000 + 37
    for prg in (aes[1], cha):
        for bits, lanes in ((1, False), (2, False), (16, False), (16, True),
                            (33, True), (128, True)):
            c_s0s = words((cb, 2, 4))
            vals = [int(v) % (1 << bits)
                    for v in rng.integers(0, 2**63, size=cb)]
            c_a = (blk.pack_inputs(vals, bits, dev) if lanes else
                   blk.words(np.array(vals, dtype=np.uint64), dev))
            c_wire = ht_cuda.gen_batch(prg, groups.Bytes(), bits, hk, c_s0s,
                                       c_a, words((cb, 4)))[0]
            c_x = c_a.clone()
            c_x.view(cb, -1)[1::2, 0] ^= 1
            flat = torch.empty(c_wire.numel() + 1, dtype=torch.int32,
                               device=dev)
            offset = flat[1:].view(c_wire.shape)
            offset.copy_(c_wire)
            for s, k in ((c_s0s[:, 1].contiguous(), c_wire),
                         (c_s0s[0, 1].contiguous(), c_wire[0].contiguous()),
                         (c_s0s[:, 1].contiguous(), offset)):
                for party in (0, 1):
                    checks.append((s, k, c_x, bits, party, prg, hk))
    refs = [ht_cuda.eval_packed_plain(*c) for c in checks]
    refs += [ht_cuda.eval_packed_plain(*a) for _, a in calls.values()]

    def outputs():
        return ([ht_cuda.eval_packed(*c) for c in checks]
                + [fn(*a) for fn, a in calls.values()])

    def same(a, b):
        if isinstance(a, (tuple, list)):
            return all(same(x, y) for x, y in zip(a, b))
        return a.shape == b.shape and torch.equal(a, b)

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

    # Every tree's libraries, built at once.
    _build.build()
    port_csrc = _build.CSRC
    trees = []  # (name, csrc, occupancy body)
    if args.parent:
        trees.append(("parent", args.parent / "fss_tpu_torch" / "csrc",
                      OCC_PARENT))
    trees.append(("port", port_csrc, OCC_PORT))
    for name, choices in VARIANTS.items():
        if name.startswith(args.only):
            trees.append((name, patch(port_csrc, name, choices),
                          OCC_DESIGNS))
    order = trees + trees[:2][::-1] if args.parent else trees + trees[:1]
    jobs, libs, logs = [], {}, {}
    for name, csrc, occ_body in trees:
        out = REPO / "build" / f"fss_tpu_torch_ht_{name}"
        out.mkdir(parents=True, exist_ok=True)
        occ = out / "occ_ht_eval.cu"
        occ.write_text(OCC_SRC % occ_body)
        srcs = {"ht_eval": csrc / "ht_eval.cu", "occ": occ}
        if name == "parent":
            srcs["ht_gen"] = csrc / "ht_gen.cu"
        for f, src in srcs.items():
            so = out / f"{f}.so"  # no digest: the parent's headers differ
            jobs.append((name, f, so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                 str(so), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, f, so, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {f}:\n{text}")
        libs[name, f], logs[name, f] = so, text
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    port_lib = _build._libs["ht_eval"]

    # The parent's and the port's Gen and staging, once each.
    spec = importlib.util.spec_from_file_location(
        "parent_block", (args.parent or REPO) / "fss_tpu_torch" / "block.py")
    parent_block = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_block)
    port_words = blk.words
    vdpf = Vdpf(n, g, ChaCha(2, NONCE), hashes=Sha256(SHA_KEY))
    draws = np.random.default_rng(7).integers(0, 2**32, size=(nkeys, 2, 4))

    def gen_calls(tree):
        """The Half-Tree Gen kernel alone (the parent's, or the port's
        without betas: the same outputs) and HalfTreeDpf.gen_batch's work
        in ``tree`` (the parent: its kernel, then the output CW in torch;
        the port: one launch) with each PRG, and Vdpf.gen_batch and the
        staging of its seed draws."""
        out = {}
        for tag, prg in (("", cha), ("_aes", aes[1])):
            if tree == "parent":
                def kernel(prg=prg):
                    fn = getattr(ctypes.CDLL(str(libs["parent", "ht_gen"])),
                                 "fss_ht_gen")
                    fn.argtypes, fn.restype = PARENT_GEN_ARGS, ctypes.c_int
                    cws = torch.empty((nkeys, n, 8), dtype=torch.int32,
                                      device=dev)
                    l0, l1 = (torch.empty((nkeys, 4), dtype=torch.int32,
                                          device=dev) for _ in range(2))
                    arg, _ = _build.prg_arg(prg, 1)
                    _build.launch("ht_gen", fn, s0s.data_ptr(),
                                  alphas.data_ptr(), 1, cws.data_ptr(),
                                  l0.data_ptr(), l1.data_ptr(), nkeys, n,
                                  *hk, arg, device=dev)
                    return cws, l0, l1

                def run(kernel=kernel):
                    cws, l0, l1 = kernel()
                    return cws, half_tree_dpf.output_cw(g, l0, l1, betas)
            else:
                def kernel(prg=prg):
                    return ht_cuda.gen_packed(s0s, alphas, n, prg, hk)

                def run(prg=prg):
                    return ht_cuda.gen_batch(prg, g, n, hk, s0s, alphas,
                                             betas)
            out[f"ht_gen_kernel{tag}"] = kernel
            out[f"ht_gen_batch{tag}"] = run
        wfn = parent_block.words if tree == "parent" else port_words

        def vdpf_gen():
            blk.words = wfn
            try:
                return vdpf.gen_batch(np.random.default_rng(7), alphas,
                                      betas)
            finally:
                blk.words = port_words

        def stage():
            out = wfn(draws, dev)
            torch.cuda.synchronize()
            return out

        out["vdpf_gen_batch_sha256"] = vdpf_gen
        out["gen_batch_stage"] = stage
        return out

    gen_refs = {}
    for name, csrc, _ in order:
        row = {"variant": name, "card": smi}
        _build._libs["ht_eval"] = ctypes.CDLL(str(libs[name, "ht_eval"]))
        got = outputs()
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, refs)) if not same(a, b)]
        row["mismatches"] = bad
        if bad:
            print(json.dumps(row), flush=True)
            continue
        ms = {k: cuda_ms(lambda fn=fn, a=a: fn(*a), args.reps)
              for k, (fn, a) in calls.items()}
        if name == "port":
            ms.update({k: cuda_ms(lambda fn=fn, a=a: fn(*a), args.reps)
                       for k, (fn, a) in port_calls.items()})
        if name in ("parent", "port"):
            for k, fn in gen_calls(name).items():
                if k == "gen_batch_stage":
                    t0 = time.perf_counter()
                    fn()
                    ms[k] = (time.perf_counter() - t0) * 1e3
                    continue
                out = fn()
                torch.cuda.synchronize()
                if not same(out, gen_refs.setdefault(k, out)):
                    row["mismatches"].append(k)
                ms[k] = cuda_ms(fn, 3 if k.startswith("vdpf") else 10)
        row["ms"] = ms
        row["ptxas"] = {k: v for k, v in chip_smoke.ptxas_usage(
            logs[name, "ht_eval"]).items() if "aes" in k}
        row["sass"] = {k: v for k, v in chip_smoke.sass_usage(
            cuobjdump, libs[name, "ht_eval"], pipes=True).items()
            if "ht_eval_kernel" in k}
        row["sass_fields"] = ["instructions", "alu", "lds", "alu_pipe",
                              "imad", "viadd", "ldg"]
        occ = (ctypes.c_int * 5)()
        rc = ctypes.CDLL(str(libs[name, "occ"])).fss_occupancy(occ)
        row["aes_wire_kernel"] = dict(zip(
            ("ctas_per_sm", "registers", "static_smem", "dynamic_smem",
             "threads"), list(occ)), occupancy_rc=rc)
        row["clocks"] = chip_smoke.nvidia_smi(
            "clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
        print(json.dumps(row), flush=True)
    _build._libs["ht_eval"] = port_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
