#!/usr/bin/env python3
"""The EvalAll kernels' plan and layouts against their alternatives, on one
GPU.

    python3 scripts/torch_eval_all_variants.py [--bits 20 24] [--reps 10]
    python3 scripts/torch_eval_all_variants.py --half-tree [--bits 20 24]

Times ``eval_all_cuda.eval_all`` and ``dcf_eval_all`` (Uint(32), party 0,
ChaCha and AES-128-MMO with the JAX bench's keys) at each domain size
under:

  two-launch   the port's plan (``eval_all_cuda.plan``): a top launch
               writes the subtree roots, the body expands them;
  one-launch   every body CTA walks from the root to its subtree root
               itself (the plan as [(0, k, b)]), no top launch;
  threads128   the port's plan, CTAs of at most 128 threads;
  threads512   the port's plan, CTAs of at most 512 threads;

each variant's shares held byte-exact against the port's. With
``--half-tree`` it times ``eval_all_cuda.ht_eval_all`` instead, under the
port's plan with each AES table layout of ``csrc/ht_eval_all.cu``
(``AesTables<32, 1>``, ``<32, 2>``) and CTAs of at most 256 or 128 threads
(``port``, ``layout<c>x<t>``, ``threads128``, both), each variant's shares
first held byte-exact against ``ht_eval_all_plain``. The variants build
patched copies of ``csrc/`` under ``build/``. The order is the port's
design, the variants, the port's design again (the first and last bound
the drift). One JSON line a variant and size, after the card's name and
power limit (nvidia-smi). Without a card the script exits 1 and prints
nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
AES_KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, nargs="+", default=[20, 24])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--half-tree", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from fss_tpu_torch import _build, groups
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.ops import eval_all_cuda as E
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import dcf, dpf

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    csrc, build_dir, port_plan = _build.CSRC, _build.BUILD_DIR, E.plan

    def patched(name, edits):
        """A copy of csrc/ under build/ with ``edits`` [(file, old, new)]."""
        d = REPO / "build" / f"csrc_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            assert old in text, (f, old)
            (d / f).write_text(text.replace(old, new))
        return d

    def threads(cap, sources=("dpf_eval_all.cu", "dcf_eval_all.cu")):
        """Edits that cap the CTAs of ``sources`` at ``cap`` threads."""
        return [("subtree.cuh", "(w > 256 ? 256 : w)",
                 f"(w > {cap} ? {cap} : w)")] + [
            (f, "__launch_bounds__(256)", f"__launch_bounds__({cap})")
            for f in sources]

    if args.half_tree:
        return half_tree(args, patched, threads)

    def one_launch(in_bits, most=E.SUBTREE_LEVELS):
        b = E.subtree_levels(in_bits, most)
        return [(0, in_bits - b, b)]

    variants = [("two-launch", csrc, port_plan),
                ("one-launch", csrc, one_launch),
                ("threads128", patched("threads128", threads(128)),
                 port_plan),
                ("threads512", patched("threads512", threads(512)),
                 port_plan),
                ("two-launch", csrc, port_plan)]
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    g = groups.Uint(32)
    prgs = {"chacha": {2: ChaCha(2, NONCE), 4: ChaCha(4, NONCE)},
            "aes": {m: AesMmo(m, AES_KEYS[:m]) for m in (2, 4)}}
    calls = {}
    for name, P in prgs.items():
        for n in args.bits:
            s0 = blk.words(rng.integers(0, 2**32, size=(1, 2, 4),
                                        dtype=np.uint64), dev)
            beta = blk.words(rng.integers(0, 2**32, size=(1, 4),
                                          dtype=np.uint64), dev)
            alpha = blk.pack_inputs([int(rng.integers(0, 2**n))], n, dev)
            cws = dpf.gen(P[2], g, n, s0, alpha, beta)[0]
            dcws = dcf.gen(P[4], g, n, "lt", s0, alpha, beta)[0]
            calls[name, n] = (
                lambda P=P, n=n, s=s0[0, 0], c=cws: E.eval_all(
                    P[2], g, n, 0, s, c),
                lambda P=P, n=n, s=s0[0, 0], c=dcws: E.dcf_eval_all(
                    P[4], g, n, 0, s, c))

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

    want = {}
    _build.build()
    port_libs = dict(_build._libs)
    for variant, src, plan in variants:
        # A variant's copy builds only the two EvalAll sources.
        _build.CSRC = src
        _build.BUILD_DIR = build_dir if src == csrc else \
            REPO / "build" / f"fss_tpu_torch_{src.name}"
        _build._libs = {k: v for k, v in port_libs.items() if src == csrc
                        or k not in ("dpf_eval_all", "dcf_eval_all")}
        E.plan = plan
        for (name, n), fns in calls.items():
            row = {"variant": variant, "prg": name, "in_bits": n}
            for scheme, fn in zip(("dpf", "dcf"), fns):
                out = fn()
                same = torch.equal(out, want.setdefault((name, n, scheme),
                                                        out))
                row[f"{scheme}_ms"] = cuda_ms(fn)
                row[f"{scheme}_same_as_port"] = same
            print(json.dumps(row), flush=True)
    _build.CSRC, _build.BUILD_DIR, E.plan = csrc, build_dir, port_plan
    _build._libs = port_libs
    return 0


def half_tree(args, patched, threads):
    """The Half-Tree EvalAll under each AES table layout and CTA cap."""
    from fss_tpu_torch import _build, groups
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.ops import eval_all_cuda as E
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import half_tree_dpf as ht

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    src = (csrc / "ht_eval_all.cu").read_text()
    port_layout = next(t for t in ("<32, 1>", "<32, 2>")
                       if f"fss::AesTables{t};" in src)
    other = "<32, 2>" if port_layout == "<32, 1>" else "<32, 1>"
    layout = [("ht_eval_all.cu", f"fss::AesTables{port_layout};",
               f"fss::AesTables{other};")]
    cap = threads(128, ("ht_eval_all.cu",))
    tag = other[1:-1].replace(", ", "x")
    variants = [("port", csrc),
                (f"layout{tag}", patched(f"ht_layout{tag}", layout)),
                ("threads128", patched("ht_threads128", cap)),
                (f"layout{tag}+threads128",
                 patched(f"ht_layout{tag}_threads128", layout + cap)),
                ("port", csrc)]
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    g = groups.Uint(32)
    hk = (0x01234567, 0x89ABCDEF, 0x0F1E2D3C, 0x4B5A6978)
    calls, want = {}, {}
    for name, prg in (("chacha", ChaCha(1, NONCE)),
                      ("aes", AesMmo(1, AES_KEYS[:1]))):
        for n in args.bits:
            s0s = blk.words(rng.integers(0, 2**32, size=(1, 2, 4),
                                         dtype=np.uint64), dev)
            beta = blk.words(rng.integers(0, 2**32, size=(1, 4),
                                          dtype=np.uint64), dev)
            alpha = blk.pack_inputs([int(rng.integers(0, 2**n))], n, dev)
            cws, ocw = ht.gen(prg, g, n, blk.words(list(hk), dev), s0s,
                              alpha, beta)
            a = (prg, g, n, 0, hk, s0s[0, 0], cws[0], ocw[0])
            calls[name, n] = lambda a=a: E.ht_eval_all(*a)
            want[name, n] = E.ht_eval_all_plain(*a)
    print(json.dumps({"port_aes_layout": port_layout}), flush=True)

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

    _build.build()
    port_libs = dict(_build._libs)
    for variant, d in variants:
        _build.CSRC = d
        _build.BUILD_DIR = build_dir if d == csrc else \
            REPO / "build" / f"fss_tpu_torch_{d.name}"
        _build._libs = {k: v for k, v in port_libs.items()
                        if d == csrc or k != "ht_eval_all"}
        for (name, n), fn in calls.items():
            same = torch.equal(fn(), want[name, n])
            print(json.dumps({"variant": variant, "prg": name, "in_bits": n,
                              "ms": cuda_ms(fn) if same else None,
                              "same_as_plain": same}), flush=True)
            if not same:
                return 1
    _build.CSRC, _build.BUILD_DIR, _build._libs = csrc, build_dir, port_libs
    return 0


if __name__ == "__main__":
    sys.exit(main())
