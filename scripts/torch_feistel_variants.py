#!/usr/bin/env python3
"""The Feistel route kernel's designs against each other, on one GPU.

    python3 scripts/torch_feistel_variants.py [--only PREFIX,...]
        [--reps 200] [--sample 1000]

Times, for each variant, at the VDMPF bench's shape (``chip_smoke.py``'s
main path: Vdmpf(16, Uint(32), ChaCha, BLAKE3 under the default IV),
``gen_retry`` from the bench's draws, 2^14 points plus the 30 alphas, so
16,414 points, kappa 3, 49,242 values):

  route_queued_ms    ``feistel_cuda.launch_route`` into the same outputs,
                     queued behind a sleep (``chip_smoke.queued_ms``): the
                     kernel's own time;
  route_wrapper_ms   ``feistel_cuda.route`` as a caller sees it;
  table_queued_ms    ``fss_feistel_permute``: the whole permutation over
                     the bench's domain (196,608 values, kappa 1);
  batch_eval_tree_ms ``Vdmpf.batch_eval`` of party 0 with the tree fold;

and ``route_h12_queued_ms``, the route queued at a shape whose halves are
too wide to tabulate: 2^15 points below n = 2^22, kappa 3 (half 12,
98,304 values, ``chip_smoke.py``'s untabulated route case), where every
pass is four AES blocks.

The variants (``VARIANTS``) are builds of one source with the choices at
its top patched: ``first*`` of ``scripts/feistel_designs.cu`` (the first
design: one thread a point; ``first`` is it as it was, ``-unroll1`` the
four Feistel rounds as a loop, ``-u64`` one 64-bit value where 2 half <=
64), the others of ``csrc/feistel.cu`` (the port: one thread a value,
the round functions tabulated where half <= 10; ``port`` is it as it
stands). ``simple`` replaces the port's ``walk_compact`` (the AES
passes, compacted into the CTA's first threads every pass) with
``SIMPLE_WALK``: each thread walks its values to the end, as on the
tabulated path. The order is the variants, then the same in reverse, so
the drift is bounded and each pair compares in one call. Each variant is
held byte-exact first against the plain versions
(``chip_smoke.feistel_cases``, computed once, and the two timed routes),
then timed with CUDA events. Each line also carries each kernel's ptxas
registers and spill bytes, its SASS size (instructions and bytes) and
its LDS, LDL, STL, LDC and ULDC counts (``cuobjdump -sass``), the
launch's plan (CTAs, values a CTA, threads, tabulated) and the SM clock;
a variant that does not build gets a line saying so. The first line is
the card's name and power limit (nvidia-smi), the second the bench
shape's passes and bound. Without a card the script exits 1 and prints
nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
DESIGNS = REPO / "scripts" / "feistel_designs.cu"

def design(tables=2, threads=512, tab=10, **functions):
    """The choices at the top of csrc/feistel.cu, as patch values, and
    whole functions replaced (name=source)."""
    return (None, {"AesTables": f"fss::AesTables<32, {tables}>",
                   "kThreads": str(threads), "kTabHalf": str(tab),
                   **functions})


# The AES passes without compaction: each thread walks its values of the
# slice to the end, as the tabulated passes do.
SIMPLE_WALK = r"""
template <class V, class Take, class Pass, class Put>
__device__ __forceinline__ void walk_compact(int len, V last, Take take,
                                             Pass pass, Put put) {
  walk<V>(len, last, take, pass, put);
}
"""

# name -> (the source patched, the choices at its top as patch values).
# first*: scripts/feistel_designs.cu; the others csrc/feistel.cu, named by
# what differs from design()'s defaults: simple (SIMPLE_WALK), walk (no
# round function tabulated: AES in every pass), ctaN (threads a CTA).
VARIANTS = {
    "first": (DESIGNS, {}),
    "port": (None, {}),
    "first-unroll1": (DESIGNS, {"kUnrollRounds": "false"}),
    "first-u64": (DESIGNS, {"kNarrow64": "true"}),
    "first-unroll1-u64": (DESIGNS, {"kUnrollRounds": "false",
                                    "kNarrow64": "true"}),
    "simple": design(walk_compact=SIMPLE_WALK),
    "walk": design(tab=0),
    "walk-simple": design(tab=0, walk_compact=SIMPLE_WALK),
    "cta128": design(threads=128),
    "cta256": design(threads=256),
    "cta1024": design(threads=1024),
}
SASS_OPS = ("LDS", "LDL", "STL", "LDC", "ULDC")


def patch(src: pathlib.Path, choices: dict) -> str:
    text = src.read_text()
    for key, value in choices.items():
        if value.lstrip().startswith("template"):  # a whole function
            text, n = re.subn(
                r"^template <[^\n]*>\n__device__ __forceinline__ void "
                rf"{key}\(.*?^}}\n", lambda m, v=value: v.lstrip("\n"),
                text, flags=re.M | re.S)
            assert n == 1, (src, key)
            continue
        text, n = re.subn(
            rf"^(using {key} = |constexpr \w+ {key} = )[^;]+;",
            lambda m, v=value: f"{m.group(1)}{v};", text, flags=re.M)
        assert n == 1, (src, key)
    return text


def kernel(mangled: str) -> str:
    """A mangled feistel_kernel<V, kRoute> -> "route" or "permute", with
    its value type (u64 or u128)."""
    m = re.search(r"feistel_kernelI([a-z])Lb([01])E", mangled)
    if not m:
        return mangled
    return (("route" if m.group(2) == "1" else "permute")
            + (" u128" if m.group(1) == "o" else " u64"))


def ptxas(text: str) -> dict:
    """``ptxas -v`` -> {kernel: [registers, spill stores, spill loads,
    stack frame bytes]}."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        def num(pattern):
            m = re.search(pattern, chunk)
            return int(m.group(1)) if m else None
        out[kernel(chunk.split("'", 1)[0])] = [
            num(r"Used (\d+) registers"), num(r"(\d+) bytes spill stores"),
            num(r"(\d+) bytes spill loads"), num(r"(\d+) bytes stack frame")]
    return out


def sass(cuobjdump: pathlib.Path, lib: pathlib.Path) -> dict:
    """{kernel: {instructions, bytes, LDS, LDL, STL, LDC, ULDC}}."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        ops = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9]*)", chunk)
        names = [op for _, op in ops]
        row = {"instructions": sum(op != "NOP" for op in names),
               "bytes": (int(ops[-1][0], 16) + 16) if ops else 0}
        row.update({op: names.count(op) for op in SASS_OPS})
        out[kernel(chunk.split(None, 1)[0])] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sample", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import DEFAULT_HASH_IV, Vdmpf
    from fss_tpu_torch.hash import Blake3
    from fss_tpu_torch.ops import feistel_cuda
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.prp.feistel import Aes128Feistel

    smi = chip_smoke.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    dev = torch.device("cuda")

    # Every variant's library, built at once beside the port's sources.
    _build.build()
    port_lib = _build._libs["feistel"]
    names = [k for k in VARIANTS if k in ("first", "port") or any(
        k.startswith(p) for p in args.only.split(","))]
    jobs, libs, logs = [], {}, {}
    for name in names:
        src, choices = VARIANTS[name]
        out = REPO / "build" / "feistel_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        cu = out / "feistel.cu"
        cu.write_text(patch(src or _build.CSRC / "feistel.cu", choices))
        so = out / "feistel.so"
        jobs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "nvcc_failed": text[-4000:]}),
                  flush=True)
            continue
        libs[name], logs[name] = so, text
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")

    # The bench's shape: chip_smoke.py's VDMPF main path (BLAKE3).
    n = 1 << chip_smoke.VDMPF_BITS
    d = Vdmpf(chip_smoke.VDMPF_BITS, group=groups.Uint(32),
              prg=ChaCha(2, chip_smoke.NONCE),
              hashes=Blake3(DEFAULT_HASH_IV), device=dev)
    vrng, alphas, betas = chip_smoke.vdmpf_inputs()
    keys = d.gen_retry(vrng, alphas, betas)
    xs = blk.words(np.concatenate([vrng.integers(
        0, n, size=1 << chip_smoke.VDMPF_LOG2_POINTS), alphas]).astype(
            np.uint32), dev)
    key, kappa = keys[0], d.kappa
    prp = Aes128Feistel(key.sigma, n * kappa)
    bench = (prp, n, kappa, key.b_size_rt, xs, 1)
    vals = torch.zeros((xs.numel(), kappa, 4), dtype=torch.int64,
                       device=dev)
    vals[..., 0] = blk.u64(xs)[:, None] + n * torch.arange(kappa,
                                                           device=dev)
    _, passes = feistel_cuda.walk_plain(prp, vals)
    print(json.dumps({"points": xs.numel(), "kappa": kappa,
                      "values": xs.numel() * kappa, "passes": passes,
                      "domain": prp.domain, "half": prp.half,
                      "b_size_rt": key.b_size_rt}), flush=True)

    # Each value's walk (passes), for the lone walks timed below: the PRP
    # of one value that walks the most passes and of one that walks one.
    y, walks = vals.reshape(-1, 4).clone(), torch.zeros(
        xs.numel() * kappa, dtype=torch.int64, device=dev)
    out = torch.ones_like(walks, dtype=torch.bool)
    while bool(out.any()):
        walks += out
        y[out] = feistel_cuda.feistel_pass_plain(prp, y[out])
        out = y[:, 0] >= prp.domain
    longest, one = int(walks.argmax()), int((walks == 1).nonzero()[0])
    lone = {w: blk.words(vals.reshape(-1, 4)[i:i + 1, 0], dev)
            for w, i in ((int(walks[longest]), longest), (1, one))}
    lone[0] = blk.words([prp.domain], dev)  # outside: not walked
    print(json.dumps({"walks": torch.bincount(walks).tolist()}), flush=True)

    cases = chip_smoke.feistel_cases(dev, np.random.default_rng(17),
                                     args.sample)
    # The untabulated shape: half 12, every pass four AES blocks.
    n12 = 1 << chip_smoke.WALK_SLICE_BITS
    rng12 = np.random.default_rng(chip_smoke.WALK_SLICE_BITS)
    prp12 = Aes128Feistel(chip_smoke._sigma(rng12), n12 * 3)
    h12 = (prp12, n12, 3, -(-n12 * 3 // 53), blk.words(rng12.integers(
        0, n12, size=1 << 15).astype(np.uint32), dev), 1)
    for case, shape in (("bench route", bench), ("h12 route", h12)):
        cases.append((case, lambda a=shape: feistel_cuda.route(*a),
                      lambda a=shape: chip_smoke.to_cpu(
                          feistel_cuda.route_plain(*a)),
                      lambda got: True))
    wants = [plain() for _, _, plain, _ in cases]
    ys_want = d.batch_eval(0, key, xs, "tree")

    order = [k for k in names + names[::-1][1:] if k in libs]
    for name in order:
        lib = ctypes.CDLL(str(libs[name]))
        _build._libs["feistel"] = lib
        row = {"variant": name, "card": smi}
        bad = []
        try:
            for (case, kernel, _, ok), want in zip(cases, wants):
                got = kernel()
                if not (chip_smoke.same(chip_smoke.to_cpu(got), want)
                        and ok(got)):
                    bad.append(case)
            if not chip_smoke.same(d.batch_eval(0, key, xs, "tree"),
                                   ys_want):
                bad.append("batch_eval tree")
        except RuntimeError as exc:  # a launch the variant cannot make
            bad.append(f"{case}: {exc}")
        row["mismatches"] = bad
        if bad:
            print(json.dumps(row), flush=True)
            continue
        out = [torch.empty_like(t) for t in feistel_cuda.route(*bench)]
        row["route_queued_ms"] = chip_smoke.queued_ms(
            lambda: feistel_cuda.launch_route(
                prp, n, kappa, key.b_size_rt, xs, *out), args.reps)
        out12 = [torch.empty_like(t) for t in feistel_cuda.route(*h12)]
        row["route_h12_queued_ms"] = chip_smoke.queued_ms(
            lambda: feistel_cuda.launch_route(*h12[:5], *out12), args.reps)
        row["route_wrapper_ms"] = chip_smoke.cuda_ms(
            lambda: feistel_cuda.route(*bench), 20)
        row["table_queued_ms"] = chip_smoke.queued_ms(
            lambda: feistel_cuda.table(prp, dev), args.reps // 4)
        # One value's walk alone in the grid: the fill, then `w` passes of
        # one lane (0: a value outside the domain, not walked); the
        # difference, a lone warp's pass.
        row["lone_ms"] = {w: chip_smoke.queued_ms(
            lambda x=x: feistel_cuda.permute(prp, x), args.reps)
            for w, x in lone.items()}
        (w_hi, t_hi), (w_lo, t_lo), _ = row["lone_ms"].items()
        row["lone_pass_clocks"] = (t_hi - t_lo) / (w_hi - w_lo) * 1.98e6
        row["batch_eval_tree_ms"] = chip_smoke.cuda_ms(
            lambda: d.batch_eval(0, key, xs, "tree"), 20)
        if hasattr(lib, "fss_feistel_plan"):
            row["plan"] = feistel_cuda.plan(prp, xs.numel() * kappa, dev)
            row["plan_h12"] = feistel_cuda.plan(prp12, 3 << 15, dev)
        row["ptxas"] = ptxas(logs[name])
        row["sass"] = sass(cuobjdump, libs[name])
        row["clocks"] = chip_smoke.nvidia_smi(
            "clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
        print(json.dumps(row), flush=True)
    _build._libs["feistel"] = port_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
