#!/usr/bin/env python3
"""Drive fss_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

  1. device: the card's name, power limit and clocks;
  2. build: nvcc builds every kernel from csrc/ (registers and spills);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, byte-exact (tolerance 0: integer crypto);
  4. golden: the reference's ChaCha DPF vectors through Dpf("cuda");
  5. main path at full size: batched DPF Gen of 2^20 keys over a 16-bit
     domain (Uint(32), ChaCha mul=2), Eval of both parties, reconstruction
     of every key, a 4096-key sample against the plain version; then
     EvalAll of one key at 20 and 24 bits, reconstructed over the domain.
     Launch counts are zeroed before and read after this phase;
  6. timing: CUDA-event times of each kernel and of the entry points at
     the main-path shapes, beside the bound of the same work.

The last lines are the kernels JSON line, the card's name and power limit
as nvidia-smi gives them, and the result JSON line.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "vectors" / "dpf.json"
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
MAIN_BITS = 16
MAIN_LOG2_KEYS = 20
EVAL_ALL_BITS = (20, 24)
SAMPLE = 4096
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Peak 32-bit ALU ops: each of an SM's 4 schedulers dispatches one 32-lane
# instruction per clock, 128 lanes per SM per clock (the 67 TFLOP/s float32
# peak counts 2 flops per such FMA lane). Integer adds also go to the
# FMA pipe (IMAD), so the 64 INT32 units per SM are not the limit.
LANES_PER_SM_CLOCK = 128
CHACHA_OPS = 960  # 10 double rounds x 8 quarter-rounds x 12 ALU ops


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the 32-bit words of two int32 results."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max()) if a.numel() else 0


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Dpf
    from fss_tpu_torch.ops import dpf_cuda, eval_all_cuda
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import dpf as plain_dpf

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)

    def words(shape, bits=32):
        return blk.words(rng.integers(0, 2**bits, size=shape,
                                      dtype=np.uint64), dev)

    # 1. device ------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * LANES_PER_SM_CLOCK * max_mhz * 1e6
    log("device", kind=kind, nvidia_smi=smi, sms=sms, max_sm_mhz=max_mhz,
        torch=torch.__version__, cuda=torch.version.cuda)

    def bound(ops: float, nbytes: float):
        t_ops, t_bytes = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    usage = {}
    for name, text in reports.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(
            r"(\d+) bytes spill stores", text)]
        usage[name] = {"registers": regs, "spill_store_bytes": spills}
    log("build", seconds=round(build_s, 3), nvcc=_build.nvcc(), ptxas=usage)

    # 3. kernels vs plain versions ----------------------------------------
    checks = []
    B = SAMPLE + 37  # ragged edge

    def domain(lanes, n):
        """[count, 4] random lanes -> values below 2^n."""
        out = lanes.clone()
        for i in range(4):
            keep = min(max(n - 32 * i, 0), 32)
            if keep < 32:
                out[:, i] &= (1 << keep) - 1
        return out

    def kernel_inputs(lanes, n):
        return lanes if n > 32 else lanes[:, 0].contiguous()

    for n in (16, 128):
        s0s, betas = words((B, 2, 4)), words((B, 4))
        alphas = domain(words((B, 4)), n)
        xs = alphas.clone()
        xs[1::2, 0] ^= 1
        xs = kernel_inputs(xs, n)
        wire = dpf_cuda.gen_batch(NONCE, groups.Uint(32), n, s0s,
                                  kernel_inputs(alphas, n), betas)
        cws_p, _ = dpf_cuda.pack_keys(wire, n)
        cases = {
            "wire": (s0s[:, 0].contiguous(), wire, False),
            "packed": (s0s[:, 1].contiguous(), cws_p, True),
            "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous(),
                          False),
        }
        for label, (s0, cws, packed) in cases.items():
            got = dpf_cuda.eval_packed(s0, cws, xs, n, 1, NONCE,
                                       packed=packed)
            want = dpf_cuda.eval_packed_plain(s0, cws, xs, n, 1, NONCE,
                                              packed=packed)
            checks.append((f"dpf_eval n={n} {label}", same(got, want)))
    for n in (16, 48):
        s0s = words((B, 2, 4))
        alphas = kernel_inputs(domain(words((B, 4)), n), n)
        for layout in ("wire", "packed"):
            got = dpf_cuda.gen_packed(s0s, alphas, n, NONCE, layout=layout)
            want = dpf_cuda.gen_packed_plain(s0s, alphas, n, NONCE,
                                             layout=layout)
            checks.append((f"dpf_gen n={n} {layout}", same(got, want)))
    prg = ChaCha(2, NONCE)
    for n in (8, 16, 20):
        g = groups.Uint(128, 1 << 127)
        s0s, beta = words((1, 2, 4)), words((1, 4))
        cws = plain_dpf.gen(prg, g, n, s0s,
                            blk.pack_inputs([int(rng.integers(0, 2**n))], n,
                                            dev), beta)[0]
        for party in (0, 1):
            got = eval_all_cuda.eval_all(prg, g, n, party, s0s[0, party], cws)
            want = plain_dpf.eval_all(prg, g, n, party, s0s[0, party], cws)
            checks.append((f"dpf_eval_all n={n} party={party}",
                           same(got, want)))
    torch.cuda.synchronize()
    bad = [name for name, ok in checks if not ok]
    log("kernels", checked=len(checks), mismatches=bad)
    if bad:
        return 1

    # 4. golden vectors on the card ---------------------------------------
    golden = [c for c in json.loads(GOLDEN.read_text())["cases"]
              if c["prg"] == "chacha"]
    gmap = {"bytes": groups.Bytes(), "uint32": groups.Uint(32),
            "uint64": groups.Uint(64),
            "uint127": groups.Uint(128, 1 << 127)}

    def hexw(h):
        return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()

    def raw(t):
        return blk.to_numpy(t).tobytes()

    failures = []
    for case in golden:
        n = case["in_bits"]
        tag = f"{case['group']}-{n}"
        d = Dpf(n, gmap[case["group"]],
                ChaCha(2, (case["nonce_lo"], case["nonce_hi"])))
        s0s = np.stack([hexw(h) for h in case["s0s"]])
        cws = d.gen(s0s, int(case["alpha"], 0), hexw(case["beta"]))
        if raw(cws) != np.stack([hexw(r) for r in case["cws"]]).tobytes():
            failures.append(f"{tag} gen")
        xs = [int(x, 0) for x in case["xs"]]
        for party in (0, 1):
            ys = d.eval(party, s0s[party], cws, xs)
            if raw(ys) != b"".join(bytes.fromhex(h)
                                   for h in case[f"ys{party}"]):
                failures.append(f"{tag} eval party{party}")
            if "eval_all_digest0" in case:
                full = raw(d.eval_all(party, s0s[party], cws))
                if (hashlib.sha256(full).hexdigest()
                        != case[f"eval_all_digest{party}"]):
                    failures.append(f"{tag} eval_all party{party}")
    log("golden", cases=len(golden), failures=failures)
    if failures or len(golden) != 6:
        return 1

    # 5. main path at full size -------------------------------------------
    nkeys = 1 << MAIN_LOG2_KEYS
    g = groups.Uint(32)
    d = Dpf(MAIN_BITS, g, ChaCha(2, NONCE))
    s0s, betas = words((nkeys, 2, 4)), words((nkeys, 4))
    alphas = words((nkeys,), MAIN_BITS)
    xs = alphas.clone()
    xs[1::2] ^= 1 + words((nkeys // 2,), MAIN_BITS - 1)  # != alpha
    n_ea = max(EVAL_ALL_BITS)
    ea_seeds, ea_beta = words((2, 4)), words((4,))
    ea_alpha = int(rng.integers(0, 2**n_ea))
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    cws = d.gen_batch(s0s, alphas, betas)
    y0 = d.eval(0, s0s[:, 0].contiguous(), cws, xs)
    y1 = d.eval(1, s0s[:, 1].contiguous(), cws, xs)
    rec = g.add(g.from_block(y0), g.from_block(y1))
    ea_rec, ea_dpf, ea_key = {}, {}, {}
    for n in EVAL_ALL_BITS:
        ea_dpf[n] = Dpf(n, g, ChaCha(2, NONCE))
        ea_key[n] = ea_dpf[n].gen(ea_seeds, ea_alpha % (1 << n), ea_beta)
        e0 = ea_dpf[n].eval_all(0, ea_seeds[0], ea_key[n])
        e1 = ea_dpf[n].eval_all(1, ea_seeds[1], ea_key[n])
        ea_rec[n] = (g.add(g.from_block(e0), g.from_block(e1)),
                     ea_alpha % (1 << n))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(_build.launches)

    want = torch.zeros_like(rec)
    want[0::2, 0] = betas[0::2, 0]
    rec_ok = torch.equal(rec, want)
    sample_ok = same(cws[:SAMPLE], plain_dpf.gen(
        d.prg, g, MAIN_BITS, s0s[:SAMPLE],
        blk.pack_inputs(alphas[:SAMPLE], MAIN_BITS), betas[:SAMPLE]))
    sample_ok &= same(y1[:SAMPLE], plain_dpf.eval_points(
        d.prg, g, MAIN_BITS, 1, s0s[:SAMPLE, 1], cws[:SAMPLE],
        blk.pack_inputs(xs[:SAMPLE], MAIN_BITS)))
    ea_ok = True
    for n, (r, a) in ea_rec.items():
        expect = torch.zeros_like(r)
        expect[a, 0] = ea_beta[0]
        ea_ok &= r.shape == (1 << n, 4) and torch.equal(r, expect)
    log("main_path", keys=nkeys, in_bits=MAIN_BITS, group=g.name,
        seconds=round(main_s, 3), reconstruct_ok=rec_ok,
        sample_vs_plain_ok=sample_ok, eval_all_bits=list(EVAL_ALL_BITS),
        eval_all_ok=ea_ok, launches=launches)
    if not (rec_ok and sample_ok and ea_ok
            and all(v > 0 for v in launches.values())):
        return 1

    # 6. timing at the main-path shapes -----------------------------------
    s0 = s0s[:, 0].contiguous()
    ev = (s0, cws, xs, MAIN_BITS, 0, NONCE)
    gv = (s0s, alphas, MAIN_BITS, NONCE)
    expand_args = (d.prg, n_ea, 0, ea_seeds[0], ea_key[n_ea])

    def kernel_expand():
        return eval_all_cuda.expand_leaves(*expand_args)

    def plain_expand():
        return eval_all_cuda.expand_leaves(
            *expand_args, expand=eval_all_cuda.expand_packed_plain)

    kernels = [
        ("dpf_eval", "fss_tpu_torch/csrc/dpf_eval.cu",
         "fss_tpu/ops/dpf_pallas.py:513",
         lambda: dpf_cuda.eval_packed(*ev),
         lambda: dpf_cuda.eval_packed_plain(*ev),
         nkeys * MAIN_BITS * CHACHA_OPS,
         nkeys * (16 + MAIN_BITS * 20 + 4 + 16 + 4)),
        ("dpf_gen", "fss_tpu_torch/csrc/dpf_gen.cu",
         "fss_tpu/ops/dpf_pallas.py:313",
         lambda: dpf_cuda.gen_packed(*gv),
         lambda: dpf_cuda.gen_packed_plain(*gv),
         nkeys * MAIN_BITS * 2 * CHACHA_OPS,
         nkeys * (32 + 4 + (MAIN_BITS + 1) * 32 + 2 * 16 + 2 * 4)),
        ("dpf_eval_all", "fss_tpu_torch/csrc/dpf_eval_all.cu",
         "fss_tpu/ops/eval_all_pallas.py:113",
         kernel_expand, plain_expand,
         ((1 << n_ea) - 1) * CHACHA_OPS,
         16 + n_ea * 20 + (1 << n_ea) * (16 + 4)),
    ]
    rows = []
    for name, src, replaces, kern, plain, ops, nbytes in kernels:
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 2)
        err = max_abs_err(kern(), plain())
        bound_ms, bound_by = bound(ops, nbytes)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        if err:
            return 1

    gen_ms = cuda_ms(lambda: d.gen_batch(s0s, alphas, betas), 10)
    eval_ms = cuda_ms(lambda: d.eval(0, s0, cws, xs), 10)
    ea_ms = {n: cuda_ms(lambda n=n: ea_dpf[n].eval_all(0, ea_seeds[0],
                                                        ea_key[n]), 5)
             for n in EVAL_ALL_BITS}
    log("timing", card=kind, power_limit=smi.split(",")[-1].strip(),
        gen_keys_per_s=nkeys / (gen_ms / 1e3), gen_ms=gen_ms,
        gen_bound_ms=rows[1]["bound_ms"],
        eval_per_s=nkeys / (eval_ms / 1e3), eval_ms=eval_ms,
        eval_bound_ms=rows[0]["bound_ms"],
        eval_all_items_per_s={n: (1 << n) / (ms / 1e3)
                              for n, ms in ea_ms.items()},
        eval_all_ms=ea_ms,
        clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu"))

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
