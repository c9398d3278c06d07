#!/usr/bin/env python3
"""Drive fss_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero):

  1. device: the card's name, power limit and clocks;
  2. build: nvcc builds every kernel from csrc/ (registers and spills;
     the hash and AES kernels' SASS instruction counts, ALU and LDS ones
     apart, beside the model counts of their bounds, ``hash_alu`` and
     ``AES_ALU``/``AES_LDS``; both chains' roles and one row of B-12,
     split by pipe; one lane's dependent add,
     LOP3, SHF, IMAD, SHFL, LDS and BLAKE3 G latencies,
     ``alu_latencies``);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, byte-exact (tolerance 0: integer crypto), every tree kernel
     with the ChaCha PRG and with AES-128-MMO (``SAMPLE``-size batches;
     the DPF, DCF, Half-Tree and VDPF walks at 16 and 48 or 128 bits; the
     DPF, DCF and Half-Tree EvalAll kernels for every group kind on both
     sides of their plan's boundary, ``CHECK_PLANS``, and the DPF's seeds
     epilogue; the VDPF EvalAll at several domains); the DCF kernels
     in each of their five accumulator modes, and the DPF and Half-Tree
     Gens' output CW for each of those five group kinds (the DPF's on wire
     and packed keys; 1, 16 and 128 bits); the Half-Tree Eval on wire
     rows, one broadcast key, rows at a 4-byte offset and x as 4 lanes;
     the hash kernels also on the reference's primitive
     vectors, the flat proof chains on 4096 points and around their
     rings' sizes (rows 16-byte aligned and not), and B-12 on points below
     2^32, 128-bit points and warps that mix them; the Feistel route
     kernel at 8-64 bits with 53 and 74 buckets (points below n and
     above it, which are not walked), its PRP alone on a domain of
     2^20 + 1 and on 4-lane points, its permutation table, and the cases
     of its slices and tabulated round functions: 1, 31, 33 points, one
     thread block's values plus one, kappa 1 and 4, a domain just above a
     power of two, every point equal, points above n strewn
     (``feistel_cases``, ``feistel_checks``);
  4. golden: the reference's DPF, DCF, Half-Tree, VDPF, Grotto and VDMPF
     vectors, ChaCha and AES, through Dpf("cuda"), Dcf("cuda"),
     HalfTreeDpf("cuda"), Vdpf("cuda"), GrottoDcf("cuda") and
     Vdmpf("cuda"), the VDPF's pi~, proofs and reference-fold EvalAll
     proofs and the VDMPF's Gen bytes and reference-fold proofs included;
  5. main paths at full size, each with the launch counts zeroed just
     before it and read just after; first with ChaCha:
     - DPF: batched Gen of 2^20 keys over a 16-bit domain (Uint(32),
       ChaCha mul=2), wire and packed (the same keys), Eval of both
       parties, reconstruction of every key, a 4096-key sample against the
       plain version; then EvalAll of one key at 20 and 24 bits,
       reconstructed over the domain;
     - DCF: the same for Dcf(16, Uint(32), ChaCha mul=4, "lt"): 2^20 keys,
       x below, at and above alpha, every key reconstructed to
       beta * (x < alpha); EvalAll at 20 and 24 bits;
     - Half-Tree: the same for HalfTreeDpf(16, Uint(32), ChaCha mul=1) with
       a random CCR hash key: 2^20 keys, half the x at alpha, every key
       reconstructed; EvalAll at 20 and 24 bits;
     - VDPF: Vdpf(16, Uint(32), ChaCha mul=2) keyed with BLAKE3, then with
       SHA-256: gen_batch of 2^20 keys from a numpy seed, Eval of both
       parties with half the x at alpha, every key reconstructed and its
       two pi~ equal, prove and verify over 4096 points of one key;
       EvalAll of one key at 20 and 24 bits with the tree fold;
     then the JAX bench's AES block (bench.py:220-360) at the same sizes,
     with AES-128-MMO keyed by bytes(range(16 i, 16 (i + 1))): the DPF
     (mul=2), the DCF (mul=4, lt), the Half-Tree DPF (mul=1) and the VDPF
     (mul=2) with SHA-256 keyed by the bench's key; then the Grotto DCF
     (ChaCha, then AES) and the VDMPF (ChaCha with BLAKE3 and with
     SHA-256, then AES with SHA-256) at the JAX bench's shapes
     (``grotto_path``, ``vdmpf_path``);
  6. timing: CUDA-event times of each kernel and of the entry points at
     the main-path shapes, beside the bound of the same work, and the
     Eval kernels on one broadcast key beside their wire rows; each timed
     kernel is held against its plain version on the same inputs; each
     EvalAll call's launches and their times; the Grotto queries and
     EvalAll, the VDMPF's batch_eval and Gen split into their parts, and
     the route kernel alone (``grotto_timing``, ``vdmpf_timing``,
     ``feistel_row``);
  7. multi-device runs (``fss_tpu_torch.parallel``, ``phase7``), each
     path with the launch counts zeroed before it and read after, on
     every rank: SHARD_RANKS ranks over gloo sharing the card run the
     DPF, DCF, Half-Tree, Grotto and VDPF (BLAKE3, then SHA-256)
     domain-sharded EvalAll at SHARD_BITS, each shard against the
     unsharded card EvalAll and reconstructed (the VDPF's two-level proof
     equal between the parties and its second chain recomputed plain;
     the whole chain plain at VDPF_CHAIN_CHECK_BITS), the PIR lookup over
     2^PIR_LOG2_ROWS rows of PIR_WORDS words, data-sharded DPF Gen and
     Eval of 2^DATA_LOG2_KEYS keys and the VDMPF's data-sharded
     BatchEval at the bench's shape; 4 ranks the 2 x 2 data x domain
     mesh (MESH2D_KEYS keys at MESH2D_BITS); one rank over NCCL; then
     the fss_crypto front door (``crypto.Dpf``/``Dcf``, ChaCha and
     AES-128-MMO: Gen, Eval of CUDA tensors, EvalAll), reconstructed
     and sampled against the CPU front door. Each rank's times are
     those of ranks sharing one card, not a scaling figure;
  8. the rest of the port (``phase8``), one line each: (a) the six sample
     twins (``samples/torch_*.py``) on the card, each with its kernels'
     launch counts; (b) ``utils.profile_trace`` around one Eval of the
     DPF main path's 2^20 keys, its trace read back for the Eval kernel's
     symbol and for the ``launch.dpf_eval`` span around the runtime call
     that launched it (the spans' clock mapped onto the trace's; the
     offsets logged); (c) the host engine (``fss_tpu_torch.native``, its
     g++ build started beside nvcc's in phase 2) against the card byte
     for byte: DPF, DCF and Half-Tree Gen and Eval of 4096 keys at 16
     bits and EvalAll of one key at 20, with ChaCha and AES-128-MMO, a
     VDPF with BLAKE3, the PRP against its permutation table; (d) the
     host engine's DPF Eval rate, with the host CPU's model.

The last lines are the kernels JSON line (each kernel's launches include
phase 7's, ``launches_multi_device``, and the twins', ``launches_samples``),
the card's name and power limit as nvidia-smi gives them, and the result
JSON line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import hashlib
import importlib
import io
import json
import os
import pathlib
import re
import resource
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "vectors"
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)
MAIN_BITS = 16
MAIN_LOG2_KEYS = 20
EVAL_ALL_BITS = (20, 24)
DCF_MAIN_LOG2_KEYS = 20
DCF_EVAL_ALL_BITS = (20, 24)
HT_MAIN_LOG2_KEYS = 20
HT_EVAL_ALL_BITS = (20, 24)
# The DPF, DCF and Half-Tree EvalAll kernel checks: (in_bits, most) on both
# sides of the plan's boundary (eval_all_cuda.plan: a top launch of k = n -
# b levels, then subtrees of b = min(most, ceil(n / 2)) levels; the top's
# CTAs walk where k > most), at K = 2 most = 8, and the default plan (most
# 12) at 20 bits, for every group kind; and the default plan's own
# boundary, K = 24, at 23 and 25 bits for Uint(32).
CHECK_PLANS = ((1, 4), (2, 4), (7, 4), (8, 4), (9, 4), (20, 12))
CHECK_WIDE_BITS = (23, 25)
DPF_SOURCES = ("dpf_eval", "dpf_gen", "dpf_eval_all")
DCF_SOURCES = ("dcf_eval", "dcf_gen", "dcf_eval_all")
HT_SOURCES = ("ht_eval", "ht_gen", "ht_eval_all")
VDPF_MAIN_LOG2_KEYS = 20
VDPF_EVAL_ALL_BITS = (20, 24)
CHECK_VDPF_EVAL_ALL_BITS = (8, 16)
VDPF_IV = (0x11111111, 0x22222222, 0x33333333, 0x44444444, 0x55555555,
           0x66666666, 0x77777777, 0x88888888)  # the JAX bench's
VDPF_SHA_KEY = (0xA1B2C3D4, 0x11223344, 0x55667788, 0x99AABBCC)
# The JAX bench's AES-128-MMO keys: the first 1, 2 or 4 of them.
AES_KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
AES_LOG2_KEYS = 20
AES_EVAL_ALL_BITS = (20, 24)
CHECK_AES_EVAL_ALL_BITS = (8, 16)  # the VDPF's
# The kernels each VDPF main path must launch: the fused eval, the DPF Gen
# levels, the DPF expansion of EvalAll, and the hash kernels (H' in the
# tree fold, the flat chain in prove).
VDPF_KERNELS = {
    h: ("vdpf_eval", "dpf_gen", "dpf_eval_all", f"{h}_xor_hash",
        f"{h}_hash64", f"{h}_chain") for h in ("blake3", "sha256")}
CHAIN_ROWS = 4096  # points of the flat chain checks and of prove
SAMPLE = 4096
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Peak 32-bit ALU ops: each of an SM's 4 schedulers dispatches one 32-lane
# instruction per clock, 128 lanes per SM per clock (the 67 TFLOP/s float32
# peak counts 2 flops per such FMA lane). Integer adds also go to the
# FMA pipe (IMAD), so the 64 INT32 units per SM are not the limit.
LANES_PER_SM_CLOCK = 128
CHACHA_OPS = 960  # 10 double rounds x 8 quarter-rounds x 12 ALU ops
SASS_ALU = ("LOP3", "IADD3", "VIADD", "SHF", "PRMT", "IMAD", "LEA")
# Of those, the ones a scheduler issues only to its ALU pipe (16 lanes: a
# warp instruction every 2 clocks), and IMAD, which goes to the FMA pipe
# (as wide); VIADD is counted apart.
SASS_ALU_PIPE = ("LOP3", "IADD3", "SHF", "PRMT", "LEA")
# One AES-128-MMO block (csrc/aes.cuh), the work the bounds count: 160
# table lookups (144 in the 9 T-table rounds, 16 in the S-box round), each
# one shared-memory load (LDS, 32 a clock per SM with no bank conflict),
# and the ALU work of the T-table form: a byte extraction a lookup (160), a
# rotation for 3 of each round's 4 (108), two 3-input XORs a word a round
# to fold 4 lookups and the round key (72), the last round's 12 shifts and
# 8 ORs, and the byte swaps and seed XORs in and out (16). The kernels'
# layouts (AesTables) do the same work with other instructions: with
# copies of Te0 and Te2 (<32, 2>) a lookup's address is one PRMT (the byte
# extraction and the lane's copy at once), a round word takes 1 rotation
# and 3 LOP3s, and the byte swaps fold into the round keys and the last
# round's PRMTs, ~324 ALU instructions; the SASS counts of phase 2 show
# what each kernel issues.
AES_LDS = 160
AES_ALU = 160 + 108 + 72 + 20 + 16
LDS_PER_SM_CLOCK = 32
# Clocks from one 32-bit ALU instruction (IADD3, LOP3, SHF, PRMT) to the
# next that reads its result: the issue latency of Volta to Hopper integer
# instructions in published microbenchmarks, an assumption of the chains'
# latency bound (hash_depth), not a measurement.
ALU_LATENCY_CLOCKS = 4
# The kernels line's rows that stand for a TPU kernel (PERF.md section 6);
# the others replace XLA glue of the JAX package.
TPU_ROWS = {name: f"B-{i}" for i, name in enumerate((
    "dpf_eval", "dpf_gen", "dpf_eval_all", "dcf_eval", "dcf_gen",
    "dcf_eval_all", "ht_eval", "ht_gen", "ht_eval_all", "blake3_xor_hash",
    "blake3_hash64", "sha256_xor_hash", "vdpf_eval", "dpf_eval_aes",
    "ht_eval_aes", "dcf_eval_aes", "dpf_gen_aes", "dcf_gen_aes"), 1)}


# The hashes' ALU instructions a row, for the bounds. One count per sm_90
# instruction: SHF (a rotate or shift), LOP3 (any bitwise function of up
# to three words), IADD3 (a sum of up to three words), PRMT (a byte swap).
# A word is (row, dep, zero): "row" if it depends on the row's data; the
# others (IV or key, padding, zero lanes) fold at compile or launch time
# and cost nothing. An XorHash's two compressions differ only in the
# domain bit (lane 3's LSB of a) and what it reaches ("dep"): the second
# counts only that, the rest is shared with the first.
ROW, CONST, ZERO, BIT = ((True, False, False), (False, False, False),
                         (False, False, True), (False, True, False))
BLAKE3_G = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))
BLAKE3_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)


class AluCount:
    def __init__(self):
        self.ops, self.second = 0, False

    def op(self, n, *xs):
        """``n`` instructions of the words ``xs``."""
        row, dep = any(x[0] for x in xs), any(x[1] for x in xs)
        if row and (dep or not self.second):
            self.ops += n
        return row, dep, all(x[2] for x in xs)

    def xor(self, x, y):
        return y if x[2] else x if y[2] else self.op(1, x, y)

    def add(self, *xs):
        """IADD3s over the row terms and one folded constant; the second
        compression adds its dep terms to the shared partial sum."""
        rows = [x for x in xs if x[0]]
        const = any(not x[0] and not x[2] for x in xs)
        dep = any(x[1] for x in xs)
        if not self.second:
            self.ops += (len(rows) + const) // 2
        elif rows and dep:
            d = sum(x[1] for x in rows)
            self.ops += (d + (len(rows) > d) + const) // 2
        return bool(rows), dep, not rows and not const


def blake3_alu(c: AluCount, m) -> None:
    """One BLAKE3 compression of the message words ``m``."""
    v = [CONST] * 12 + [ZERO, ZERO, CONST, CONST]
    for _ in range(7):
        for i, (a, b, cc, d) in enumerate(BLAKE3_G):
            for x in m[2 * i:2 * i + 2]:
                v[a] = c.add(v[a], v[b], x)
                v[d] = c.op(1, c.xor(v[d], v[a]))
                v[cc] = c.add(v[cc], v[d])
                v[b] = c.op(1, c.xor(v[b], v[cc]))
        m = [m[p] for p in BLAKE3_PERM]
    for i in range(8):
        c.xor(v[i], v[i + 8])


def sha256_alu(c: AluCount, words) -> None:
    """One SHA-256 digest of ``words`` (key, message and padding; 16 a
    block), with the byte swaps in and out."""
    st = [CONST] * 8
    for k in range(0, len(words), 16):
        w = [c.op(1, x) for x in words[k:k + 16]]
        v = list(st)
        for t in range(64):
            j = t % 16
            if t >= 16:
                w[j] = c.add(w[j], c.op(4, w[(t + 1) % 16]), w[(t + 9) % 16],
                             c.op(4, w[(t + 14) % 16]))
            a, b, cc, d, e, f, g, h = v
            t1 = c.add(h, c.op(4, e), c.op(1, e, f, g), CONST, w[j])
            v = [c.add(t1, c.op(4, a), c.op(1, a, b, cc)), a, b, cc,
                 c.add(d, t1), e, f, g]
        st = [c.add(x, y) for x, y in zip(st, v)]
    for x in st:
        c.op(1, x)


def hash_depth(name: str) -> int:
    """Dependent ALU instructions of one step of the flat proof chain
    (``csrc/blake3.cu``, ``csrc/sha256.cu``: m = pi ^ pt, H'(m), pi ^= h):
    the longest path through it, counting each instruction on it once (a
    3-input add or logic op, a funnel shift, a byte swap), with the
    rotations and shifts that feed one XOR in parallel. A step waits on the
    last one's pi words (lanes 0-7 of m); cs, the point and the constants
    are off the path."""
    if name == "blake3":
        m, v = [1] * 8 + [0] * 8, [0] * 16
        for _ in range(7):
            for i, (a, b, c, d) in enumerate(BLAKE3_G):
                for x in m[2 * i:2 * i + 2]:
                    v[a] = max(v[a], v[b], x) + 1  # a + b + m
                    v[d] = max(v[d], v[a]) + 2     # XOR, rotate
                    v[c] = max(v[c], v[d]) + 1
                    v[b] = max(v[b], v[c]) + 2
            m = [m[p] for p in BLAKE3_PERM]
        return max(max(v[i], v[i + 8]) for i in range(8)) + 1

    def block(st, w):
        a, b, c, d, e, f, g, h = st
        for t in range(64):
            j = t % 16
            if t >= 16:  # two sigmas (rotations in parallel, one LOP3),
                w[j] = max(w[j], w[(t + 1) % 16] + 2, w[(t + 9) % 16],
                           w[(t + 14) % 16] + 2) + 2  # then two adds
            t1 = max(max(h, w[j]) + 1, e + 2, max(e, f, g) + 1) + 1
            a, b, c, d, e, f, g, h = (max(t1, a + 2, max(a, b, c) + 1) + 1,
                                      a, b, c, max(d, t1) + 1, e, f, g)
        return [max(x, y) + 1 for x, y in zip(st, (a, b, c, d, e, f, g, h))]

    # Block 1: the key, m[0..7] (pi ^ pt, byte-swapped) and m[8..11];
    # block 2: m[12..15] and the padding, off the path.
    st = block(block([0] * 8, [0] * 4 + [2] * 8 + [0] * 4), [0] * 16)
    return max(st) + 2  # byte swap, pi ^= h


def hash_alu(name: str, use: str) -> int:
    """ALU instructions a row of ``use``: "xor_hash" H(x, b) with x below
    2^32 (lanes 1-3 zero, as on every main path here) or "hash64" H'."""
    c = AluCount()
    if use == "hash64":
        if name == "blake3":
            blake3_alu(c, [ROW] * 16)
        else:
            sha256_alu(c, [CONST] * 4 + [ROW] * 16 + [CONST] + [ZERO] * 10
                       + [CONST])
        return c.ops
    for c.second in (False, True):
        x = [ROW, ZERO, ZERO, BIT, ROW, ROW, ROW, ROW]
        if name == "blake3":
            blake3_alu(c, x + [ZERO] * 8)
        else:
            sha256_alu(c, [CONST] * 4 + x + [CONST, ZERO, ZERO, CONST])
    return c.ops


_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _START, 1)}),
          flush=True)


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


def queued_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs queued behind a sleep
    of ~50 ms on the stream, so that the host's time to launch each (longer
    than a short kernel's run) leaves no gaps between them."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)  # clock cycles
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


def to_cpu(t):
    """A tensor, or a tuple of them, on the CPU."""
    return tuple(x.cpu() for x in t) if isinstance(t, tuple) else t.cpu()


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


def kernel_name(mangled: str) -> str:
    """A mangled entry function -> kernel<template args>, the PRG type
    argument as "chacha" or "aes<copies>x<tables>" (its tables' layout).
    Each name in it follows its length in digits, which may run on from the
    anonymous namespace's hex digest, so every tail of a digit run is
    tried."""
    name = mangled
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            cand = mangled[run.end():run.end() + int(mangled[i:run.end()])]
            if cand.endswith("_kernel"):
                name = cand
    aes = re.compile(r"6AesPrgILi\dEN(?:S\d*_|3fss)9AesTablesILi(\d+)ELi(\d)"
                     r"EEE")
    args = re.findall(r"L[ib](\d+)E", aes.sub("", mangled))
    if "9ChaChaPrg" in mangled:
        args.append("chacha")
    layout = aes.search(mangled)
    if layout:  # the AES tables' layout, aes.cuh: AesTables<copies, tables>
        args.append(f"aes{layout.group(1)}x{layout.group(2)}")
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_usage(text: str) -> dict:
    """``ptxas -v`` output -> {kernel: [registers, spill store bytes]} for
    each entry function."""
    usage = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        usage[kernel_name(chunk.split("'", 1)[0])] = [
            int(regs.group(1)) if regs else None,
            int(spill.group(1)) if spill else None]
    return usage


def sass_usage(cuobjdump: pathlib.Path, lib: pathlib.Path,
               pipes: bool = False) -> dict:
    """``cuobjdump -sass`` of a library (or cubin) -> {kernel:
    [instructions, ALU instructions (SASS_ALU), shared-memory loads (LDS)]},
    and with ``pipes`` the ALU ones split by pipe as well, and the global
    loads: [..., ALU-pipe (SASS_ALU_PIPE), IMAD, VIADD, LDG]. A thread's
    count for a kernel with no
    loop, a row's (the loop body, plus a little) for the chains' roles, a
    level's (plus a little) for the walks."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    usage = {}
    for chunk in text.split("Function : ")[1:]:
        ops = [op for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", chunk)
            if op != "NOP"]
        usage[kernel_name(chunk.split(None, 1)[0])] = [
            len(ops), sum(op in SASS_ALU for op in ops),
            sum(op == "LDS" for op in ops)] + ([
                sum(op in SASS_ALU_PIPE for op in ops),
                ops.count("IMAD"), ops.count("VIADD"),
                ops.count("LDG")] if pipes else [])
    return usage


# The SHA-256 chain kernel's three roles, each alone in a kernel of its
# own, so that the SASS counts show what each issues (the chain lane's are
# one row's); and one row of B-12. Built from csrc/sha256.cu, never
# launched.
CHAIN_ROLES_SRC = """#include "sha256.cu"
__global__ void chain_lane_role_kernel(const uint32_t* cs, uint32_t* out,
                                       int64_t n,
                                       const __grid_constant__
                                       fss::Sha256Key key) {
  __shared__ Slot ring[kRing];
  __shared__ HelperBuf hb;
  __shared__ uint64_t full[kRing], empty[kRing], wbar, sbar[kPieces];
  chain_lane(cs, out, n, key, ring, full, empty, hb, &wbar, sbar);
}
__global__ void chain_producer_role_kernel(const uint32_t* pts,
                                           const uint32_t* cs, int64_t n,
                                           const __grid_constant__
                                           fss::Sha256Key key) {
  __shared__ Slot ring[kRing];
  __shared__ uint64_t full[kRing], empty[kRing];
  chain_producer<true>(pts, cs, n, key, ring[0], full, empty, 0);
}
__global__ void chain_helper_role_kernel(int64_t n,
                                         const __grid_constant__
                                         fss::Sha256Key key) {
  __shared__ Slot ring[kRing];
  __shared__ HelperBuf hb;
  __shared__ uint64_t wbar, sbar[kPieces];
  chain_helper(n, ring, hb, &wbar, sbar, ChainAdd{key.one});
}
__global__ void xor_row_kernel(const uint4* ab, uint4* out,
                               const __grid_constant__ fss::Sha256Key key) {
  const uint4 qa = ab[0], qb = ab[1];
  const uint32_t a[4] = {qa.x, qa.y, qa.z, qa.w};
  const uint32_t b[4] = {qb.x, qb.y, qb.z, qb.w};
  uint32_t o[16];
  xor_hash_row(key, a, b, o);
  for (int i = 0; i < 4; ++i)
    out[i] = make_uint4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}
"""

# The BLAKE3 chain kernel's two roles, the same way: the chain lanes (a
# row's SASS in the loop) and a producer lane. Built from csrc/blake3.cu.
BLAKE3_CHAIN_ROLES_SRC = """#include "blake3.cu"
__global__ void chain_lanes_role_kernel(const uint32_t* cs, uint32_t* out,
                                        int64_t n,
                                        const __grid_constant__ ChainIv iv) {
  __shared__ ChainSlot ring[kRing];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ __align__(16) uint32_t hand[kShflWords ? 1 : 16];
  chain_lanes(cs, out, n, iv, ring, full, empty, hand,
              kChainLanes == 1 ? 0 : (int)threadIdx.x);
}
__global__ void chain_producer_role_kernel(const uint32_t* pts,
                                           const uint32_t* cs, int64_t n) {
  __shared__ ChainSlot ring[kRing];
  __shared__ uint64_t full[kRing], empty[kRing];
  chain_producer<true>(pts, cs, n, ring[0], full, empty, 0);
}
"""


def chain_role_usage(nvcc: str, cuobjdump: pathlib.Path,
                     csrc: pathlib.Path, out_dir: pathlib.Path,
                     src: str = CHAIN_ROLES_SRC,
                     name: str = "sha256_chain_roles") -> dict:
    """SASS counts (with pipes) of a chain's roles, ``src`` built into a
    cubin beside the libraries."""
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    cubin = path.with_suffix(".cubin")
    subprocess.run([nvcc, "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", str(csrc), "-o", str(cubin), str(path)],
                   check=True, capture_output=True, text=True, timeout=600)
    return sass_usage(cuobjdump, cubin, pipes=True)


# One lane's dependent chains, timed with clock64 on the card: a 32-bit
# add (ADD: ptxas makes a chain of adds IMAD.IADDs or IADD3s as it likes),
# LOP3 (a three-input majority), SHF (a funnel shift), IMAD, SHFL (a 4-lane
# __shfl_sync, the chains' shuffle), LDS (a load whose address is the last
# one's value: the shared-memory hand-over's round trip), and G (BLAKE3's
# G mix, 12 dependent IADD3, LOP3 and SHF instructions: the flat chains'
# path is made of such steps). Each kernel times kSteps x iters steps.
LATENCY_SRC = r"""#include <cuda_runtime.h>
#include <cstdint>
constexpr int kSteps = 256;
__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
template <int kOp>
__device__ __forceinline__ void step(uint32_t (&s)[4], uint32_t y,
                                     uint32_t z) {
  uint32_t& x = s[0];
  if constexpr (kOp == 0) {
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if constexpr (kOp == 1) {
    asm volatile("lop3.b32 %0, %0, %1, %2, 0xE8;" : "+r"(x) : "r"(y), "r"(z));
  } else if constexpr (kOp == 2) {
    asm volatile("shf.r.wrap.b32 %0, %0, %1, 13;" : "+r"(x) : "r"(y));
  } else if constexpr (kOp == 3) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(y), "r"(z));
  } else if constexpr (kOp == 4) {
    x = __shfl_sync(0xFu, x, (threadIdx.x + 1) & 3, 4);
  } else if constexpr (kOp == 5) {
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(x));
  } else {
    uint32_t &a = s[0], &b = s[1], &c = s[2], &d = s[3];
    a = a + b + y; d = rotr(d ^ a, 16); c = c + d; b = rotr(b ^ c, 12);
    a = a + b + z; d = rotr(d ^ a, 8);  c = c + d; b = rotr(b ^ c, 7);
  }
}
template <int kOp>
__global__ void latency_kernel(long long* out, uint32_t seed, int iters) {
  __shared__ uint32_t ring[16];
  if (threadIdx.x >= 4) return;
  if (threadIdx.x == 0)
    for (int i = 0; i < 16; ++i)
      ring[i] = (uint32_t)__cvta_generic_to_shared(ring + (i + 1) % 16);
  __syncwarp(0xFu);
  uint32_t ys[8], zs[8];
  for (int i = 0; i < 8; ++i) ys[i] = seed * (2 * i + 3), zs[i] = seed ^ i;
  uint32_t s[4] = {kOp == 5 ? (uint32_t)__cvta_generic_to_shared(ring)
                            : seed + threadIdx.x,
                   seed * 5, seed * 7, seed * 11};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) step<kOp>(s, ys[j & 7], zs[j & 7]);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    out[2 * kOp] = t1 - t0, out[2 * kOp + 1] = s[0] ^ s[1] ^ s[2] ^ s[3];
}
extern "C" int fss_latency(long long* out, uint32_t seed, int iters,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  latency_kernel<0><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<1><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<2><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<3><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<4><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<5><<<1, 32, 0, s>>>(out, seed, iters);
  latency_kernel<6><<<1, 32, 0, s>>>(out, seed, iters);
  return (int)cudaGetLastError();
}
"""
# Each chain's name and the SASS mnemonics its steps are made of.
LATENCY_OPS = {"ADD": ("IADD3", "IMAD"), "LOP3": ("LOP3",),
               "SHF": ("SHF",), "IMAD": ("IMAD",), "SHFL": ("SHFL",),
               "LDS": ("LDS",), "G": ("IADD3", "IMAD", "LOP3", "SHF", "PRMT")}


def alu_latencies(nvcc: str, cuobjdump: pathlib.Path,
                  out_dir: pathlib.Path, iters: int = 64) -> dict:
    """Clocks a step of each of LATENCY_OPS's dependent chains on one lane
    (LATENCY_SRC, built into a library beside the others), each kernel's
    SASS count of the instructions its steps are made of ("sass": its loop
    has 256 steps, G's 12 instructions each) and of all its instructions
    ("sass_all"), and the clocks a step's instruction ("clocks_per_sass":
    the steps' clocks over that count)."""
    import ctypes
    src = out_dir / "alu_latency.cu"
    src.write_text(LATENCY_SRC)
    so = src.with_suffix(".so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(so)).fss_latency
    fn.argtypes = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
                   ctypes.c_void_p)
    out = torch.zeros(2 * len(LATENCY_OPS), dtype=torch.int64,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the first call warms the instruction caches
        if fn(out.data_ptr(), 12345, iters, stream):
            raise RuntimeError("latency kernels failed to launch")
    torch.cuda.synchronize()
    clocks = out.cpu().tolist()[0::2]
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    names = list(LATENCY_OPS)
    counts = {}
    for chunk in text.split("Function : ")[1:]:
        k = re.search(r"latency_kernelILi(\d)E", chunk.split(None, 1)[0])
        if k:
            name = names[int(k.group(1))]
            ops = re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                chunk)
            counts[name] = (sum(map(ops.count, LATENCY_OPS[name])),
                            len(ops))
    result = {}
    for i, name in enumerate(names):
        n, n_all = counts.get(name, (0, None))
        result[name] = {"clocks_per_step": clocks[i] / (256 * iters),
                        "sass": n, "sass_all": n_all,
                        "clocks_per_sass": clocks[i] / (iters * n) if n
                        else None}
    return result


def hexw(h):
    """Hex bytes -> their little-endian uint32 words."""
    return np.frombuffer(bytes.fromhex(h), dtype="<u4").copy()


def raw(t):
    """An int32 tensor's bytes."""
    from fss_tpu_torch import block as blk
    return blk.to_numpy(t).tobytes()


def case_prg(case, mul):
    """A golden case's PRG: AES-MMO with its first ``mul`` keys, or ChaCha
    with its nonce."""
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    if case["prg"] == "aes":
        return AesMmo(mul, [bytes.fromhex(k) for k in case["aes_keys"][:mul]])
    return ChaCha(mul, (case["nonce_lo"], case["nonce_hi"]))


# ---------------------------------------------------------------------------
# The Grotto DCF and the VDMPF: their checks (phases 3 and 4), main paths
# (phase 5) and timings (phase 6)
# ---------------------------------------------------------------------------

# The route kernel's checks: indices as words (to 29 bits) and as lanes,
# halves of up to 32 bits and above (33 and 64 bits: the 4-lane points),
# and 53 and 74 buckets; a PRP whose walk takes many passes (a domain of
# 2^20 + 1 in a 2^22 network) and one of 4-lane points; the table. Then
# the cases that CTAs walking slices of the values or tabulating the
# round functions can get wrong (``feistel_cases``):
# counts of 1, 31 and 33 points, one CTA's threads plus one value, kappa
# 1 and 4 (2^16 points: more values than the grid has threads), a domain
# just above a power of two (3 n = 2^16 + 2: four passes a value, lanes
# landing many passes apart), every point equal, points at or above n
# strewn among 2^15 points, and an untabulated walk (half 12) whose CTAs'
# slices pass their threads.
ROUTE_CHECK_BITS = (8, 16, 22, 23, 29, 30, 33, 64)
WALK_CHECK_DOMAIN = (1 << 20) + 1
TABLE_CHECK_DOMAIN = 3 << 8
REFILL_CHECK_COUNTS = (1, 31, 33)
NEAR_POW2_N = 21846  # 3 n = 2^16 + 2
WALK_SLICE_BITS = 22  # half 12: AES passes, 98,304 values
# The JAX bench's shapes (bench.py:679-735): a 20-bit Grotto key at alpha
# 123456 queried at 2^20 points, EvalAll at 20 (alpha 500) and 24 bits; a
# 16-bit VDMPF, t = 30, 2^14 points plus the alphas.
GROTTO_BITS = 20
GROTTO_ALPHA = 123456
GROTTO_LOG2_QUERIES = 20
GROTTO_EVAL_ALL_BITS = (20, 24)
GROTTO_EA_ALPHA = 500
VDMPF_BITS = 16
VDMPF_T = 30
VDMPF_LOG2_POINTS = 14
# The route kernel's lookups an AES block (csrc/feistel.cu): the last
# round computes the words the round function keeps, word 0 for a right
# half of up to 32 bits (160 - 12), words 0 and 1 above (160 - 8).
FEISTEL_LDS = {"narrow": AES_LDS - 12, "wide": AES_LDS - 8}
FEISTEL_REPLACES = ("XLA: fss_tpu/prp/feistel.py:151 (Aes128Feistel.permu; "
                    "permu_lanes :201) and the Locate of "
                    "fss_tpu/schemes/vdmpf.py:118 (route)")


def _sigma(rng) -> bytes:
    return bytes(rng.integers(0, 256, size=16, dtype=np.uint8))


def feistel_cases(dev, rng, sample: int) -> list:
    """The route kernel's checks (phase 3): [(name, kernel, plain, ok)],
    ``kernel()`` a call of the wrapper, ``plain()`` its plain version's on
    the same inputs copied to the CPU (its loops of small ops run faster
    there than on the card), ``ok(got)`` what else the output must show.
    Routes at
    every ROUTE_CHECK_BITS on ``sample`` points below n and 64 at or above
    it (outside the function: not walked, bucket -1) with 53 and 74
    buckets; the PRP of points on WALK_CHECK_DOMAIN and of 4-lane points;
    the permutation table at TABLE_CHECK_DOMAIN (also against the host
    oracle and as a permutation); then the cases named above
    REFILL_CHECK_COUNTS."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.ops import feistel_cuda
    from fss_tpu_torch.prp.feistel import Aes128Feistel
    cases = []

    def lost_ones(got):
        return bool((got[0][-64:] == -1).any())

    def route(name, n, kappa, vals, m_rt, ok=lambda got: True, lanes=1):
        prp = Aes128Feistel(_sigma(rng), n * kappa)
        xs = (blk.words(np.asarray(vals, dtype=np.uint64), dev)
              if 2 * n <= 2**32 else blk.pack_inputs(vals, 128, dev))
        args = (prp, n, kappa, -(-n * kappa // m_rt), xs, lanes)
        cases.append((name, lambda: feistel_cuda.route(*args),
                      lambda: feistel_cuda.route_plain(*args[:4], xs.cpu(),
                                                       lanes), ok))

    def below(n, count):
        return [int(v) % n for v in rng.integers(0, 2**63, size=count)]

    for bits in ROUTE_CHECK_BITS:
        n = 1 << bits
        vals = below(n, sample) + [n + v for v in below(n, 64)]
        for m_rt in (53, 74):
            route(f"feistel_route n={bits} m_rt={m_rt}", n, 3, vals, m_rt,
                  lost_ones, 1 if bits <= 29 else 4)
    prp = Aes128Feistel(_sigma(rng), WALK_CHECK_DOMAIN)
    xs = blk.words(rng.integers(0, prp.domain, size=sample,
                                dtype=np.uint64), dev)
    cases.append((f"feistel_permute domain={prp.domain}",
                  lambda: feistel_cuda.permute(prp, xs),
                  lambda: feistel_cuda.permute_plain(prp, xs.cpu()),
                  lambda got: True))
    wide = Aes128Feistel(_sigma(rng), 3 << 64)
    x4 = blk.pack_inputs([int(v) % wide.domain for v in rng.integers(
        0, 2**63, size=sample)], 128, dev)
    cases.append(("feistel_permute domain=3*2^64 lanes",
                  lambda: feistel_cuda.permute(wide, x4),
                  lambda: feistel_cuda.permute_plain(wide, x4.cpu()),
                  lambda got: True))
    small = Aes128Feistel(_sigma(rng), TABLE_CHECK_DOMAIN)
    cases.append((
        f"feistel table domain={small.domain}",
        lambda: small.permutation_table(dev),
        lambda: feistel_cuda.table_plain(small, "cpu"),
        lambda got: (got.tolist() == [small.permu_host(x)
                                      for x in range(small.domain)]
                     and sorted(got.tolist()) == list(range(small.domain)))))

    n = 1 << 16
    for count in REFILL_CHECK_COUNTS:
        route(f"feistel_route count={count}", n, 3, below(n, count), 53)
    count = feistel_cuda.plan(Aes128Feistel(_sigma(rng), n), 1, dev)[1] + 1
    route(f"feistel_route kappa=1 count={count}", n, 1, below(n, count), 53)
    for kappa in (1, 4):
        route(f"feistel_route kappa={kappa} 2^16 points", n, kappa,
              below(n, 1 << 16), 53)
    route(f"feistel_route n=2^{WALK_SLICE_BITS} 2^15 points (AES walk, "
          "slices beyond the grid's threads)", 1 << WALK_SLICE_BITS, 3,
          below(1 << WALK_SLICE_BITS, 1 << 15), 53)
    route(f"feistel_route n={NEAR_POW2_N} (3 n = 2^16 + 2)", NEAR_POW2_N, 3,
          below(NEAR_POW2_N, 1 << 14), 53)
    route("feistel_route every point equal", n, 3,
          [int(rng.integers(0, n))] * (1 << 14), 53)
    vals = below(n, 1 << 15)
    for i in np.flatnonzero(rng.random(len(vals)) < 0.1):
        vals[i] += n * int(rng.integers(1, 4))
    # x + n k at or above the domain 3 n: bucket -1, index all ones
    lost = torch.as_tensor(np.asarray(vals)[:, None] + n * np.arange(3)
                           >= 3 * n, device=dev)
    route("feistel_route points >= n strewn", n, 3, vals, 53,
          lambda got: bool((got[0][lost] == -1).all()
                           and (got[1][lost] == -1).all()
                           and (got[0][~lost] >= 0).all()))
    return cases


def feistel_checks(dev, rng, sample: int) -> list:
    """Phase 3: each of ``feistel_cases`` byte-exact against its plain
    version, and what else it must show. Returns [(name, ok)]."""
    checks = []
    for name, kernel, plain, ok in feistel_cases(dev, rng, sample):
        got = kernel()
        checks.append((name, same(to_cpu(got), plain()) and ok(got)))
    return checks


def grotto_golden_case(case, failures: list, dev) -> None:
    """Phase 4: Gen's bytes, both parties' ys at every x through the
    ParityTree and the PrefixTable, and both EvalAll heads and digests."""
    from fss_tpu_torch.api import GrottoDcf
    n = case["in_bits"]
    tag = f"grotto {case['prg']}-{n}-{case['alpha']}"
    d = GrottoDcf(n, case_prg(case, 2), device=dev)
    s0s = np.stack([hexw(h) for h in case["s0s"]])
    cws = d.gen(s0s, int(case["alpha"], 0))
    if raw(cws) != np.stack([hexw(r) for r in case["cws"]]).tobytes():
        failures.append(f"{tag} gen")
    xs = [int(x, 0) for x in case["xs"]]
    for party in (0, 1):
        want = [int(y) for y in case[f"ys{party}"]]
        for how in ("preprocess", "preprocess_prefix"):
            pt = getattr(d, how)(party, s0s[party], cws)
            if d.eval(pt, xs).tolist() != want:
                failures.append(f"{tag} {how} eval party{party}")
        full = d.eval_all(party, s0s[party], cws).cpu().numpy().astype(
            np.uint8).tobytes()
        if (full[:32] != bytes.fromhex(case[f"eval_all_head{party}"])
                or hashlib.sha256(full).hexdigest()
                != case[f"eval_all_digest{party}"]):
            failures.append(f"{tag} eval_all party{party}")


def vdmpf_golden_case(case, failures: list, dev) -> None:
    """Phase 4: m, m_rt, b_size_rt, Gen's bytes (every bucket's cws, cs and
    ocw, both parties' seeds), and both parties' ys and proofs with the
    reference fold."""
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Vdmpf
    from fss_tpu_torch.hash import Blake3, Sha256
    tag = (f"vdmpf {case['prg']}-{case['hash']}-{case['in_bits']}-"
           f"t{case['t']}")
    hashes = (Sha256(hexw(case["hash_key"])) if case["hash"] == "sha256"
              else Blake3(np.concatenate([hexw(h)
                                          for h in case["blake3_iv"]])))
    d = Vdmpf(case["in_bits"], max_points=case["max_points"],
              bucket_bits=case["bucket_bits"], group=groups.Uint(64),
              prg=case_prg(case, 2), hashes=hashes, device=dev)
    s0s = np.stack([np.stack([hexw(a), hexw(b)]) for a, b in zip(
        case["bucket_s0s0"], case["bucket_s0s1"])])
    k0, k1, fail = d.gen(bytes.fromhex(case["sigma"]), s0s,
                         [int(a, 0) for a in case["alphas"]],
                         np.stack([hexw(h) for h in case["betas"]]))
    buckets = case["buckets"]
    if (fail or d.m != case["m"] or k0.m_rt != case["m_rt"]
            or k0.b_size_rt != case["b_size_rt"]
            or raw(k0.cws) != np.stack([np.stack([hexw(r) for r in b["cws"]])
                                        for b in buckets]).tobytes()
            or raw(k0.cs) != b"".join(bytes.fromhex(b["cs"])
                                      for b in buckets)
            or raw(k0.ocw) != b"".join(bytes.fromhex(b["ocw"])
                                       for b in buckets)
            or raw(k0.s0) + raw(k1.s0) != b"".join(
                bytes.fromhex(h) for h in case["bucket_s0s0"]
                + case["bucket_s0s1"])):
        failures.append(f"{tag} gen")
    xs = [int(x, 0) for x in case["xs"]]
    for party, key in ((0, k0), (1, k1)):
        ys, pi = d.batch_eval(party, key, xs, fold="reference")
        if raw(ys) != b"".join(bytes.fromhex(h)
                               for h in case[f"ys{party}"]):
            failures.append(f"{tag} ys party{party}")
        if raw(pi) != bytes.fromhex(case[f"pi{party}"]):
            failures.append(f"{tag} pi party{party}")


def grotto_path(prg2, sfx: str, dev, rng):
    """5e. Grotto at the bench's shape: Gen at GROTTO_BITS, both parties'
    prefix tables and parity trees, 2^GROTTO_LOG2_QUERIES queries through
    each, reconstructed to 1[alpha <= x]; EvalAll of a key at each of
    GROTTO_EVAL_ALL_BITS, reconstructed over the domain."""
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.api import GrottoDcf
    d = GrottoDcf(GROTTO_BITS, prg2, device=dev)
    ea = {b: GrottoDcf(b, prg2, device=dev) for b in GROTTO_EVAL_ALL_BITS}
    s0s = blk.words(rng.integers(0, 2**32, size=(2, 4), dtype=np.uint64),
                    dev)
    q = blk.words(rng.integers(0, 2**GROTTO_BITS,
                               size=1 << GROTTO_LOG2_QUERIES,
                               dtype=np.uint64), dev)
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    cws = d.gen(s0s, GROTTO_ALPHA)
    tables = [d.preprocess_prefix(p, s0s[p], cws) for p in (0, 1)]
    rec = d.eval(tables[0], q) ^ d.eval(tables[1], q)
    trees = [d.preprocess(p, s0s[p], cws) for p in (0, 1)]
    rec_tree = d.eval(trees[0], q) ^ d.eval(trees[1], q)
    ea_keys, ea_rec = {}, {}
    for b, e in ea.items():
        ea_keys[b] = e.gen(s0s, GROTTO_EA_ALPHA)
        ea_rec[b] = (e.eval_all(0, s0s[0], ea_keys[b])
                     ^ e.eval_all(1, s0s[1], ea_keys[b]))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k + sfx: _build.launches[k + sfx]
                for k in ("dpf_gen", "dpf_eval_all")}

    want = (blk.u64(q) >= GROTTO_ALPHA).to(torch.int32)
    rec_ok, tree_ok = torch.equal(rec, want), torch.equal(rec_tree, want)
    ea_ok = all(torch.equal(r, (torch.arange(1 << b, device=dev)
                                >= GROTTO_EA_ALPHA).to(torch.int32))
                for b, r in ea_rec.items())
    log("main_path", scheme="grotto", prg=type(prg2).__name__,
        in_bits=GROTTO_BITS, queries=q.numel(), seconds=round(main_s, 3),
        prefix_table_ok=rec_ok, parity_tree_ok=tree_ok,
        eval_all_bits=list(ea), eval_all_ok=ea_ok, launches=launches)
    ok = (rec_ok and tree_ok and ea_ok
          and all(v > 0 for v in launches.values()))
    return ok, dict(d=d, ea=ea, ea_keys=ea_keys, s0s=s0s, cws=cws, q=q,
                    tables=tables, trees=trees, main_s=main_s,
                    launches=launches)


def vdmpf_inputs(bits: int = VDMPF_BITS):
    """The bench's VDMPF draws: default_rng(7), the sorted distinct alphas
    below 2^bits, betas with lane 0 below 2^31; the Generator goes on to
    Gen's draws."""
    vrng = np.random.default_rng(7)
    alphas = sorted(vrng.choice(1 << bits, size=VDMPF_T,
                                replace=False).tolist())
    betas = np.zeros((VDMPF_T, 4), dtype=np.uint32)
    betas[:, 0] = vrng.integers(0, 2**31, size=VDMPF_T)
    return vrng, alphas, betas


def vdmpf_path(prg2, sfx: str, name: str, hashes, dev):
    """5f. VDMPF(VDMPF_BITS, Uint(32)) keyed with ``hashes``: gen_retry from
    the bench's draws, batch_eval of both parties at 2^VDMPF_LOG2_POINTS
    random points plus the alphas with the tree fold and with the
    reference fold; every point reconstructs (beta_j at alpha_j, else 0),
    the shares of both folds agree and each fold's proofs are equal."""
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Vdmpf
    g = groups.Uint(32)
    d = Vdmpf(VDMPF_BITS, group=g, prg=prg2, hashes=hashes, device=dev)
    vrng, alphas, betas = vdmpf_inputs()
    kernels = ("feistel_route", f"vdpf_eval{sfx}", f"dpf_gen{sfx}",
               f"{name}_xor_hash", f"{name}_hash64", f"{name}_chain")
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    keys = d.gen_retry(vrng, alphas, betas)
    xs = blk.words(np.concatenate([vrng.integers(
        0, 1 << VDMPF_BITS, size=1 << VDMPF_LOG2_POINTS), alphas]).astype(
            np.uint32), dev)
    out = {fold: [d.batch_eval(p, k, xs, fold) for p, k in enumerate(keys)]
           for fold in ("tree", "reference")}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in kernels}

    beta_of = dict(zip(alphas, betas[:, 0].tolist()))
    want = g.from_block(blk.pack_inputs(np.asarray(
        [beta_of.get(int(x), 0) for x in blk.to_numpy(xs)],
        dtype=np.uint32), 32, dev))
    rec_ok = all(torch.equal(g.add(y0, y1), want)
                 for (y0, _), (y1, _) in out.values())
    proofs_ok = {fold: d.verify(p0, p1)
                 for fold, ((_, p0), (_, p1)) in out.items()}
    folds_agree = all(torch.equal(out["tree"][p][0], out["reference"][p][0])
                      for p in (0, 1))
    plain = vdmpf_vs_plain(d, keys[0], xs, {f: o[0] for f, o in out.items()})
    log("main_path", scheme="vdmpf", prg=type(prg2).__name__, hash=name,
        in_bits=VDMPF_BITS, t=VDMPF_T, points=xs.numel(), m=d.m,
        m_rt=keys[0].m_rt, b_size_rt=keys[0].b_size_rt,
        bucket_bits=d.bucket_bits, entries=xs.numel() * d.kappa,
        seconds=round(main_s, 3), reconstruct_ok=rec_ok,
        proofs_equal=proofs_ok, folds_agree=folds_agree, launches=launches,
        **plain)
    ok = (rec_ok and all(proofs_ok.values()) and folds_agree
          and plain["inner_eval_vs_plain_ok"]
          and all(plain["party0_vs_plain_ok"].values())
          and all(v > 0 for v in launches.values()))
    return ok, dict(d=d, keys=keys, xs=xs, main_s=main_s,
                    launches=launches)


def vdmpf_vs_plain(d, key, xs, got: dict) -> dict:
    """Party 0 of the VDMPF main path against the plain versions, exactly:
    the fused eval's shares and pi~ at the main path's gathered rows and
    indices against ``eval_packed_plain`` on the card (with the same
    correction and finalize), and ``got`` (fold -> party 0's (ys, pi) from
    the main path) against a CPU Vdmpf on the same key and points, whose
    every step (route, eval, hash64, chains) is its plain version."""
    from fss_tpu_torch.api import Vdmpf
    from fss_tpu_torch.ops import vdpf_cuda
    from fss_tpu_torch.schemes import dpf as dpf_s
    from fss_tpu_torch.schemes import vdmpf as vm
    from fss_tpu_torch.schemes import vdpf as vdpf_s
    bucket, index = vm.route(key, VDMPF_BITS, xs, d.kappa)
    b, j = bucket.reshape(-1).long(), index.reshape(-1)
    rows = (key.s0[b], key.cws[b], key.cs[b], key.ocw[b])
    ys_e, pt_e = vdpf_cuda.eval_points(d.prg, d.hashes, d.group,
                                       d.bucket_bits, 0, *rows, j)
    so, t, pi = vdpf_cuda.eval_packed_plain(rows[0], rows[1], j,
                                            d.bucket_bits, 0, d.prg,
                                            d.hashes)
    eval_ok = (torch.equal(ys_e, dpf_s.finalize_leaves(d.group, 0, so, t,
                                                       rows[3]))
               and torch.equal(pt_e, vdpf_s.correct_(pi, t, rows[2])))
    t0 = time.perf_counter()
    dc = Vdmpf(VDMPF_BITS, max_points=d.max_points,
               bucket_bits=d.bucket_bits, group=d.group, prg=d.prg,
               hashes=d.hashes, kappa=d.kappa, ch_lambda=d.ch_lambda,
               device="cpu")
    kc = vm.VdmpfKey(key.sigma, key.m_rt, key.b_size_rt,
                     *(a.cpu() for a in key[3:]))
    folds_ok = {}
    for fold, (ys, pi) in got.items():
        ys_c, pi_c = dc.batch_eval(0, kc, xs.cpu(), fold)
        folds_ok[fold] = (torch.equal(ys.cpu(), ys_c)
                          and torch.equal(pi.cpu(), pi_c))
    return {"inner_eval_rows": b.numel(), "inner_eval_vs_plain_ok": eval_ok,
            "party0_vs_plain_ok": folds_ok,
            "cpu_plain_s": time.perf_counter() - t0}


def feistel_row(V, bound, launches: int) -> dict:
    """The kernels line's feistel_route row at the VDMPF main path's shape
    (its points, its key), held against route_plain: ``ms`` the kernel's
    launches back to back into the same outputs
    (``feistel_cuda.launch_route``, the wrapper's own launch without its
    checks and allocations), queued behind a sleep (``queued_ms``: the
    host takes longer to launch one than the kernel to run);
    ``wrapper_ms`` those of ``feistel_cuda.route`` as a caller sees them.
    The bound is the function's: x in, bucket and index out, and the
    least AES work, each round function over every right half once (4 x
    2^half blocks, ``FEISTEL_LDS`` lookups each, ALU instructions in
    AES_ALU's proportion) and one lookup a Feistel round of this run's
    cycle walks, where that is less than AES in every pass of the walks
    (4 blocks a pass), else the latter. ``design_bound_ms`` counts the
    work the launch does where it tabulates (``feistel_cuda.plan``):
    each CTA's own table; ``walk_bound_ms`` the AES walk's."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.ops import feistel_cuda
    from fss_tpu_torch.prp.feistel import Aes128Feistel
    d, key, xs = V["d"], V["keys"][0], V["xs"]
    n, kappa = 1 << VDMPF_BITS, d.kappa
    prp = Aes128Feistel(key.sigma, n * kappa)
    args = (prp, n, kappa, key.b_size_rt, xs, 1)
    got = feistel_cuda.route(*args)
    err = max_abs_err(got, feistel_cuda.route_plain(*args))
    wrapper_ms = cuda_ms(lambda: feistel_cuda.route(*args), 20)
    plain_ms = cuda_ms(lambda: feistel_cuda.route_plain(*args), 2)
    out = [torch.empty_like(t) for t in got]
    ms = queued_ms(lambda: feistel_cuda.launch_route(
        prp, n, kappa, key.b_size_rt, xs, *out), 200)
    err = max(err, max_abs_err(tuple(out), got))
    vals = torch.zeros((xs.numel(), kappa, 4), dtype=torch.int64,
                       device=xs.device)
    vals[..., 0] = blk.u64(xs)[:, None] + n * torch.arange(
        kappa, device=xs.device)
    _, passes = feistel_cuda.walk_plain(prp, vals)
    entries = xs.numel() * kappa
    nbytes = xs.numel() * 4 + entries * (4 + 4)
    lds = FEISTEL_LDS["narrow" if prp.half <= 32 else "wide"]

    def aes_bound(blocks, lookups=0):
        return bound(blocks * AES_ALU * lds / AES_LDS + 2 * lookups, nbytes,
                     blocks * lds + lookups)

    walk_blocks, table_blocks = 4 * passes, 4 << prp.half
    plan = feistel_cuda.plan(prp, entries, xs.device)
    if table_blocks < walk_blocks:
        bound_ms, bound_by = aes_bound(table_blocks, 4 * passes)
    else:
        bound_ms, bound_by = aes_bound(walk_blocks)
    design_bound_ms = (aes_bound(plan[0] * table_blocks, 4 * passes)[0]
                       if plan[3] else aes_bound(walk_blocks)[0])
    walk_bound_ms = aes_bound(walk_blocks)[0]
    return {"name": "feistel_route", "route": "cuda",
            "source": "fss_tpu_torch/csrc/feistel.cu",
            "replaces": FEISTEL_REPLACES, "status": "ported",
            "tpu_row": "XLA glue", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "wrapper_ms": wrapper_ms, "walk_passes": passes,
            "values": entries, "plan": dict(zip(
                ("ctas", "slice", "threads", "tabulated"), plan)),
            "table_aes_blocks": table_blocks, "lookups_a_block": lds,
            "design_bound_ms": design_bound_ms,
            "walk_bound_ms": walk_bound_ms}


def vdmpf_timing(V, power_limit: str, kind: str) -> None:
    """6. The VDMPF's entry points at the main path's shape: batch_eval end
    to end with each fold, and its parts on the same inputs (the point
    check, route with the key's PRP made once as ``Vdmpf`` keeps it, the
    row gathers, the fused eval kernel, its correction and finalize glue,
    the group fold, each fold); gen_retry end to end, its host Cuckoo
    insertion apart."""
    from fss_tpu_torch.ops import vdpf_cuda
    from fss_tpu_torch.schemes import cuckoo
    from fss_tpu_torch.schemes import vdmpf as vm
    d, key, xs = V["d"], V["keys"][0], V["xs"]
    prp = vm.key_prp(key, VDMPF_BITS, d.kappa)
    bucket, index = vm.route(key, VDMPF_BITS, xs, d.kappa, prp)
    b, j = bucket.reshape(-1).long(), index.reshape(-1)
    rows = (key.s0[b], key.cws[b], key.cs[b], key.ocw[b])
    ys_e, pt_e = vdpf_cuda.eval_points(d.prg, d.hashes, d.group,
                                       d.bucket_bits, 0, *rows, j)
    parts = {
        "point_check_ms": cuda_ms(lambda: vm.check_points(xs, VDMPF_BITS),
                                  20),
        "route_ms": cuda_ms(lambda: vm.route(key, VDMPF_BITS, xs, d.kappa,
                                             prp), 20),
        "row_gathers_ms": cuda_ms(lambda: (key.s0[b], key.cws[b], key.cs[b],
                                           key.ocw[b]), 20),
        "inner_eval_kernel_ms": cuda_ms(lambda: vdpf_cuda.eval_packed(
            rows[0], rows[1], j, d.bucket_bits, 0, d.prg, d.hashes), 20),
        "inner_eval_ms": cuda_ms(lambda: vdpf_cuda.eval_points(
            d.prg, d.hashes, d.group, d.bucket_bits, 0, *rows, j), 20),
        "group_fold_ms": cuda_ms(lambda: vm.group_fold(d.group, ys_e,
                                                       d.kappa), 20),
        "tree_fold_ms": cuda_ms(lambda: vm.tree_fold(d.hashes, key.cs,
                                                     pt_e), 10),
        "reference_fold_ms": cuda_ms(lambda: vm.reference_fold(
            d.hashes, key.cs, b, pt_e), 3),
    }
    e2e = {fold: cuda_ms(lambda f=fold: d.batch_eval(0, key, xs, f),
                         10 if fold == "tree" else 3)
           for fold in ("tree", "reference")}

    def gen():
        vrng, alphas, betas = vdmpf_inputs()
        d.gen_retry(vrng, alphas, betas)
        torch.cuda.synchronize()

    gen()
    t0 = time.perf_counter()
    for _ in range(3):
        gen()
    gen_ms = (time.perf_counter() - t0) / 3 * 1e3
    _, alphas, _ = vdmpf_inputs()
    n = 1 << VDMPF_BITS
    t0 = time.perf_counter()
    table = cuckoo.compact_run(prp, alphas, key.m_rt, n, key.b_size_rt,
                               1000, d.kappa)
    cuckoo_ms = (time.perf_counter() - t0) * 1e3
    log("timing", scheme="vdmpf", prg=type(d.prg).__name__,
        hash=type(d.hashes).__name__, card=kind, power_limit=power_limit,
        points=xs.numel(), entries=b.numel(),
        batch_eval_points_per_s={f: xs.numel() / (ms / 1e3)
                                 for f, ms in e2e.items()},
        batch_eval_ms=e2e, batch_eval_parts=parts,
        gen_retry_ms=gen_ms, gen_cuckoo_host_ms=cuckoo_ms,
        cuckoo_placed=sum(j != -1 for j, _ in table),
        clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu"))


def grotto_timing(G, power_limit: str, kind: str) -> None:
    """6. Grotto at the main path's shape: the query batch against the
    prefix table and the parity tree (queries/s), the prefix table's
    preprocessing, and EvalAll at each of GROTTO_EVAL_ALL_BITS (items/s),
    with the expand_leaves kernel apart from the scan and the packing."""
    from fss_tpu_torch.ops import eval_all_cuda
    from fss_tpu_torch.schemes import grotto_dcf as gr
    d, q, s0 = G["d"], G["q"], G["s0s"][0]
    query_ms = cuda_ms(lambda: d.eval(G["tables"][0], q), 20)
    tree_query_ms = cuda_ms(lambda: d.eval(G["trees"][0], q), 5)
    prefix_ms = cuda_ms(lambda: d.preprocess_prefix(0, s0, G["cws"]), 5)
    ea = {}
    for b, e in G["ea"].items():
        k = G["ea_keys"][b]
        _, t = eval_all_cuda.expand_leaves(e.prg, b, 0, s0, k[:b])
        bits = gr.prefix_scan(t)
        ms = cuda_ms(lambda e=e, k=k: e.eval_all(0, s0, k), 5)
        ea[b] = {"eval_all_ms": ms, "items_per_s": (1 << b) / (ms / 1e3),
                 "expand_leaves_ms": cuda_ms(
                     lambda e=e, b=b, k=k: eval_all_cuda.expand_leaves(
                         e.prg, b, 0, s0, k[:b]), 5),
                 "scan_ms": cuda_ms(lambda t=t: gr.prefix_scan(t), 5),
                 "pack_ms": cuda_ms(lambda bits=bits: gr.build_prefix_table(
                     bits, 0), 5)}
    log("timing", scheme="grotto", prg=type(d.prg).__name__, card=kind,
        power_limit=power_limit, in_bits=GROTTO_BITS, queries=q.numel(),
        prefix_queries_per_s=q.numel() / (query_ms / 1e3),
        prefix_query_ms=query_ms,
        parity_tree_queries_per_s=q.numel() / (tree_query_ms / 1e3),
        parity_tree_query_ms=tree_query_ms, preprocess_prefix_ms=prefix_ms,
        eval_all=ea, main_path_s=G["main_s"],
        clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu"))


# ---------------------------------------------------------------------------
# Phase 7: multi-device runs (fss_tpu_torch.parallel) and the front door
# ---------------------------------------------------------------------------

SHARD_RANKS = 2          # ranks sharing the one card over gloo
SHARD_BITS = 24          # the five tree schemes' domain-sharded EvalAll
SHARD_ALPHA = 0xAAAAAA   # in the upper shard at 24 bits
VDPF_CHAIN_CHECK_BITS = 12  # the two-level chain recomputed plain
DATA_BITS = 16           # data-sharded DPF Gen and Eval (bench.py:1-14)
DATA_LOG2_KEYS = 20
PIR_LOG2_ROWS = 22       # 2^22 rows x 16 words: 64-byte records, 256 MiB
PIR_WORDS = 16
PIR_INDEX = 3_141_592
MESH2D_BITS = 20         # the 2 x 2 data x domain mesh
MESH2D_KEYS = 4
FRONT_BITS = 16          # crypto.Dpf / Dcf(16, "uint", prg)
FRONT_LOG2_POINTS = 20
FRONT_EVAL_ALL_BITS = 20
FRONT_SAMPLE = 512       # points held against the CPU front door
SHARED_CARD = ("ranks sharing one card, time-sliced: each rank's own "
               "times, not a scaling figure")


def phase7_sizes() -> dict:
    """Phase 7's shapes for the ranks, which import this module anew."""
    return {k: globals()[k] for k in (
        "SHARD_BITS", "SHARD_ALPHA", "VDPF_CHAIN_CHECK_BITS", "DATA_BITS",
        "DATA_LOG2_KEYS", "PIR_LOG2_ROWS", "PIR_WORDS", "PIR_INDEX",
        "MESH2D_BITS", "MESH2D_KEYS", "VDMPF_BITS", "VDMPF_LOG2_POINTS")}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    """(fn(), its ms): CUDA events around it on the card (the host clock
    elsewhere)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def _stream(dev):
    """``dev`` as this thread's device (a new thread starts on device 0)
    and a new CUDA stream on it as the current one, after the default
    stream's work (nothing off the card)."""
    stack = contextlib.ExitStack()
    if dev.type == "cuda":
        stack.enter_context(torch.cuda.device(dev))
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        stack.enter_context(torch.cuda.stream(s))
    return stack


def _counted(dev, fn):
    """(fn(), the launches it made): the counts zeroed just before it and
    read just after."""
    from fss_tpu_torch import _build
    _sync(dev)
    _build.reset_launches()
    out = fn()
    _sync(dev)
    return out, {k: v for k, v in _build.launches.items() if v}


def _record(path, launches, needs, checks: dict, **detail) -> dict:
    """One path's result: ``exact`` all its checks, ``launched`` every
    kernel in ``needs`` launched in its counted run."""
    return {"path": path, "launches": launches,
            "exact": all(bool(v) for v in checks.values()),
            "launched": all(launches.get(k, 0) > 0 for k in needs),
            "checks": {k: bool(v) for k, v in checks.items()}, **detail}


def _memory() -> dict:
    """MiB: the card's free and total memory and what this process's
    allocator holds of it, the host's available memory and this process's
    peak resident size. Phase 7's ranks share both with this process."""
    free, total = torch.cuda.mem_get_info()
    host = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                host = int(line.split()[1]) >> 10
    return {"card_free_mib": free >> 20, "card_total_mib": total >> 20,
            "card_reserved_here_mib": torch.cuda.memory_reserved() >> 20,
            "host_available_mib": host,
            "max_rss_here_mib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss >> 10}


def _rank_device(dev_type: str):
    return (torch.device("cuda", torch.cuda.current_device())
            if dev_type == "cuda" else torch.device("cpu"))


def _rows(t, r: int, count: int):
    """Shard r of ``count`` of t's rows."""
    rows = t.shape[0] // count
    return t[r * rows:(r + 1) * rows]


def _tree_paths(Z, dev, mesh, r: int, count: int,
                names=("dpf", "dcf", "half_tree", "grotto")) -> list:
    """7a. The DPF, DCF (lt), Half-Tree and Grotto domain-sharded EvalAll
    at SHARD_BITS (Uint(32), ChaCha): Gen and both parties' sharded
    EvalAll counted and timed; each shard against the same rows of the
    unsharded card EvalAll, and the parties' shares reconstructed over
    the shard."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Dcf, Dpf, GrottoDcf, HalfTreeDpf
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    n, alpha = Z["SHARD_BITS"], Z["SHARD_ALPHA"]
    g = groups.Uint(32)
    rng = np.random.default_rng(70)
    s0s = blk.words(rng.integers(0, 2**32, size=(2, 4), dtype=np.uint64),
                    dev)
    hk = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    beta = blk.words([0x12345678, 0, 0, 0], dev)
    x = _rows(torch.arange(1 << n, device=dev), r, count)
    schemes = {
        "dpf": (Dpf(n, g, ChaCha(2, NONCE), device=dev),
                pm.dpf_eval_all_sharded, ("dpf_gen", "dpf_eval_all")),
        "dcf": (Dcf(n, g, ChaCha(4, NONCE), device=dev),
                pm.dcf_eval_all_sharded, ("dcf_gen", "dcf_eval_all")),
        "half_tree": (HalfTreeDpf(n, g, ChaCha(1, NONCE), hash_key=hk,
                                  device=dev),
                      pm.half_tree_eval_all_sharded,
                      ("ht_gen", "ht_eval_all")),
        "grotto": (GrottoDcf(n, ChaCha(2, NONCE), device=dev),
                   pm.grotto_eval_all_sharded, ("dpf_gen", "dpf_eval_all")),
    }
    out = []
    for name in names:
        d, sharded, needs = schemes[name]
        ms = []

        def run():
            key = (d.gen(s0s, alpha) if name == "grotto"
                   else d.gen(s0s, alpha, beta))
            key = key if isinstance(key, tuple) else (key,)
            head = ((d.prg, d.group) if name != "grotto" else (d.prg,))
            extra = (d.hash_key,) if name == "half_tree" else ()
            ys = []
            for p in (0, 1):
                y, t = _timed(dev, lambda p=p: sharded(
                    *head, n, p, *extra, s0s[p], *key, mesh))
                ys.append(y.to_local())
                ms.append(t)
            return key, ys

        (key, ys), launches = _counted(dev, run)
        unsharded = all(torch.equal(ys[p], _rows(d.eval_all(
            p, s0s[p], *key), r, count)) for p in (0, 1))
        if name == "grotto":
            rec, want = ys[0] ^ ys[1], (x >= alpha).to(torch.int32)
        else:
            rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0]
            hit = x < alpha if name == "dcf" else x == alpha
            want = torch.where(hit, 0x12345678, 0).to(torch.int32)
        out.append(_record(name, launches, needs,
                           {"same_as_unsharded": unsharded,
                            "reconstructs": torch.equal(rec, want)},
                           in_bits=n, shard_rows=x.numel(), ms=ms))
    return out


def _vdpf_paths(Z, dev, meshes, r: int, count: int) -> list:
    """7b. The VDPF's sharded EvalAll at SHARD_BITS (Uint(32), ChaCha),
    keyed with BLAKE3, then SHA-256: Gen and both parties counted and
    timed, the parties at once (a thread, a CUDA stream and a "domain"
    mesh of its own each, ``meshes``), so that their level-1 chains, one
    thread block each, overlap. The shares against the unsharded card
    EvalAll's and reconstructed; pi equal between the parties; the shard
    proofs gathered for the second chain (the chain calls recorded)
    holding this rank's own, and pi the plain chain from cs over them.
    Then, at VDPF_CHAIN_CHECK_BITS, the whole two-level chain recomputed
    plain from the unsharded pi~."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Vdpf
    from fss_tpu_torch.hash import Blake3, Sha256
    from fss_tpu_torch.ops import eval_all_cuda, vdpf_cuda
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import vdpf as plain_vdpf
    g = groups.Uint(32)
    beta = blk.words([0x0BADCAFE, 0, 0, 0], dev)
    prove = vdpf_cuda.prove
    party_of = threading.local()
    out = []
    for hname, hashes in (("blake3", Blake3(VDPF_IV)),
                          ("sha256", Sha256(VDPF_SHA_KEY))):
        res = {}
        for n in (Z["SHARD_BITS"], Z["VDPF_CHAIN_CHECK_BITS"]):
            d = Vdpf(n, g, ChaCha(2, NONCE), hashes=hashes, device=dev)
            alpha = Z["SHARD_ALPHA"] % (1 << n)
            calls = {0: [], 1: []}

            def recording(h, pts, cs):
                calls[party_of.p].append((pts, prove(h, pts, cs)))
                return calls[party_of.p][-1][1]

            def party(p, s0, key):
                party_of.p = p
                with _stream(dev):
                    return _timed(dev, lambda: pm.vdpf_eval_all_sharded(
                        d.prg, hashes, g, n, p, s0, *key, meshes[p]))

            def run():
                s0s, *key = d.gen_retry(np.random.default_rng(71), alpha,
                                        beta)
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    got = list(pool.map(party, (0, 1), s0s, (key, key)))
                return s0s, key, got

            vdpf_cuda.prove = recording
            try:
                (s0s, key, got), launches = _counted(dev, run)
            finally:
                vdpf_cuda.prove = prove
            (y0, pi0), (y1, pi1) = (o for o, _ in got)
            ys = [y0.to_local(), y1.to_local()]
            # per party: this shard's chain, then the shard proofs' chain
            level1, gathered = calls[0][0][1], calls[0][1][0]
            full, _ = eval_all_cuda.vdpf_eval_all(
                d.prg, hashes, g, n, 0, s0s[0], *key, "tree")
            x = _rows(torch.arange(1 << n, device=dev), r, count)
            rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0]
            checks = {
                "same_as_unsharded": torch.equal(ys[0], _rows(full, r,
                                                              count)),
                "reconstructs": torch.equal(rec, torch.where(
                    x == alpha, 0x0BADCAFE, 0).to(torch.int32)),
                "parties_pi_equal": torch.equal(pi0, pi1),
                "own_shard_proof_gathered": torch.equal(gathered[r], level1),
                "second_chain_plain": torch.equal(vdpf_cuda.prove_plain(
                    hashes, gathered, key[1]), pi0)}
            if n == Z["VDPF_CHAIN_CHECK_BITS"]:
                pts = {}
                plain_vdpf.leaf_outputs(
                    lambda a, b: vdpf_cuda.xor_hash(hashes, a, b),
                    lambda p, c: pts.setdefault("pi~", p), g, 0,
                    *eval_all_cuda.expand_leaves(d.prg, n, 0, s0s[0],
                                                 key[0]), key[1], key[2])
                level1s = torch.stack([vdpf_cuda.prove_plain(
                    hashes, _rows(pts["pi~"], i, count), key[1])
                    for i in range(count)])
                checks["two_level_chain_plain"] = torch.equal(
                    vdpf_cuda.prove_plain(hashes, level1s, key[1]), pi0)
            res[n] = (launches, checks, [t for _, t in got])
        launches, checks, ms = res[Z["SHARD_BITS"]]
        checks.update({f"{k}@{Z['VDPF_CHAIN_CHECK_BITS']}": v for k, v in
                       res[Z["VDPF_CHAIN_CHECK_BITS"]][1].items()})
        out.append(_record(f"vdpf_{hname}", launches,
                           ("dpf_gen", "dpf_eval_all", f"{hname}_xor_hash",
                            f"{hname}_chain"), checks,
                           in_bits=Z["SHARD_BITS"], ms=ms,
                           parties_at_once=True))
    return out


def _pir_path(Z, dev, mesh, r: int, count: int) -> dict:
    """7c. ``pir_lookup_sharded`` over 2^PIR_LOG2_ROWS rows of PIR_WORDS
    words (each rank makes its own rows on the card from their indices):
    Gen and both parties' answers counted and timed; the answers add to
    the row."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Dpf
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    n, words = Z["PIR_LOG2_ROWS"], Z["PIR_WORDS"]

    def rows(first, count_rows):
        i = torch.arange(first * words, (first + count_rows) * words,
                         dtype=torch.int64, device=dev)
        v = (i * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) ^ (i >> 7)
        return blk.i32(v >> 29).reshape(count_rows, words)

    local = 1 << (n - (count.bit_length() - 1))
    db = rows(r * local, local)
    d = Dpf(n, groups.Uint(32), ChaCha(2, NONCE), device=dev)
    s0s = blk.words(np.random.default_rng(72).integers(
        0, 2**32, size=(2, 4), dtype=np.uint64), dev)
    ms = []

    def run():
        cws = d.gen(s0s, Z["PIR_INDEX"], (1, 0, 0, 0))
        answers = []
        for p in (0, 1):
            a, t = _timed(dev, lambda p=p: pm.pir_lookup_sharded(
                d.prg, n, p, s0s[p], cws, db, mesh))
            answers.append(a)
            ms.append(t)
        return answers

    answers, launches = _counted(dev, run)
    row = blk.u64(rows(Z["PIR_INDEX"], 1)[0])
    got = (blk.u64(answers[0]) + blk.u64(answers[1])) & blk.MASK32
    return _record("pir", launches, ("dpf_gen", "dpf_eval_all"),
                   {"answer_is_the_row": torch.equal(got, row)},
                   rows=1 << n, words=words, db_bytes=(1 << n) * words * 4,
                   ms=ms)


def _data_path(Z, dev, mesh, r: int, count: int) -> dict:
    """7d. Data-sharded DPF Gen and Eval (``shard_batch``): 2^DATA_LOG2_KEYS
    keys over a DATA_BITS domain (Uint(32), ChaCha), this rank's slice
    through Gen and both parties' Eval at each key's alpha, counted and
    timed; every key of the slice reconstructs to its beta."""
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Dpf
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    B, n = 1 << Z["DATA_LOG2_KEYS"], Z["DATA_BITS"]
    rng = np.random.default_rng(73)
    g = groups.Uint(32)
    d = Dpf(n, g, ChaCha(2, NONCE), device=dev)
    s0s, alphas, betas = (pm.shard_batch(mesh, a, "data").to_local()
                          for a in (
        rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint64),
        rng.integers(0, 1 << n, size=B, dtype=np.uint64),
        rng.integers(0, 2**32, size=(B, 4), dtype=np.uint64)))
    ms = {}

    def run():
        cws, ms["gen"] = _timed(dev, lambda: d.gen_batch(
            s0s, alphas, betas, layout="packed"))
        ys = []
        for p in (0, 1):
            y, ms[f"eval_{p}"] = _timed(dev, lambda p=p: d.eval(
                p, s0s[:, p].contiguous(), cws, alphas))
            ys.append(y)
        return ys

    ys, launches = _counted(dev, run)
    rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0]
    return _record("data_sharded_dpf", launches, ("dpf_gen", "dpf_eval"),
                   {"every_key_reconstructs": torch.equal(rec,
                                                          betas[:, 0])},
                   keys=B, local_keys=alphas.numel(), in_bits=n, ms=ms)


def _vdmpf_path(Z, dev, mesh, r: int, count: int) -> dict:
    """7e. ``vdmpf_batch_eval_sharded`` at the bench's shape (VDMPF_BITS,
    t = VDMPF_T, 2^VDMPF_LOG2_POINTS points plus the alphas; Uint(32),
    ChaCha, BLAKE3 under the default IV): Gen and both parties counted
    and timed. The shares against the unsharded ``Vdmpf.batch_eval``'s
    rows, pi equal between the parties and the plain chain from zero over
    every shard's own tree-fold proof, recomputed here; the shares
    reconstruct to the payloads."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import DEFAULT_HASH_IV, Vdmpf
    from fss_tpu_torch.hash import Blake3
    from fss_tpu_torch.ops import vdpf_cuda
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    g = groups.Uint(32)
    n = Z["VDMPF_BITS"]
    d = Vdmpf(n, group=g, prg=ChaCha(2, NONCE),
              hashes=Blake3(DEFAULT_HASH_IV), device=dev)
    vrng, alphas, betas = vdmpf_inputs(n)
    xs = np.concatenate([vrng.integers(0, 1 << n,
                                       size=1 << Z["VDMPF_LOG2_POINTS"]),
                         alphas]).astype(np.uint32)
    ms = []

    def run():
        keys = d.gen_retry(vrng, alphas, betas)
        got = []
        for p in (0, 1):
            o, t = _timed(dev, lambda p=p: pm.vdmpf_batch_eval_sharded(
                d.prg, d.hashes, g, n, d.bucket_bits, p, keys[p], xs,
                mesh, "data"))
            got.append(o)
            ms.append(t)
        return keys, got

    (keys, got), launches = _counted(dev, run)
    eta, rows = len(xs), -(-len(xs) // count)
    padded = np.zeros(rows * count, np.uint32)
    padded[:eta] = xs
    shard_pis = torch.stack([d.batch_eval(0, keys[0], padded[
        i * rows:(i + 1) * rows])[1] for i in range(count)])
    merged = vdpf_cuda.prove_plain(d.hashes, shard_pis, torch.zeros(
        (4, 4), dtype=torch.int32, device=dev))
    full, _ = d.batch_eval(0, keys[0], xs)
    ys = [y.to_local() for y, _ in got]
    mine = xs[r * rows:(r + 1) * rows]
    beta_of = dict(zip(alphas, betas[:, 0].tolist()))
    want = blk.words([beta_of.get(int(v), 0) for v in mine], dev)
    rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0]
    return _record("vdmpf", launches,
                   ("dpf_gen", "blake3_xor_hash", "feistel_route",
                    "vdpf_eval", "blake3_hash64", "blake3_chain"),
                   {"same_as_unsharded": torch.equal(
                       ys[0], full[r * rows:r * rows + ys[0].shape[0]]),
                    "parties_pi_equal": torch.equal(got[0][1], got[1][1]),
                    "merge_chain_plain": torch.equal(merged, got[0][1]),
                    "reconstructs": torch.equal(rec, want)},
                   points=eta, local_points=ys[0].shape[0], t=VDMPF_T,
                   in_bits=n, ms=ms)


def shard_rank(rank: int, world: int, dev_type: str, Z: dict) -> list:
    """One of SHARD_RANKS ranks: 7a-7e on a 1D "domain" mesh and a 1D
    "data" mesh of the world (the VDPF's parties on a "domain" mesh each,
    over groups of their own). Returns the paths' records."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from fss_tpu_torch.parallel import mesh as pm
    dev = _rank_device(dev_type)
    domain = pm.make_mesh(axis_names=("domain",), device_type=dev_type)
    data = pm.make_mesh(axis_names=("data",), device_type=dev_type)
    parties = [DeviceMesh.from_group(dist.new_group(list(range(world))),
                                     dev_type, mesh_dim_names=("domain",))
               for _ in (0, 1)]
    pm.replicate(domain, [0, 0, 0, 0])  # DTensor's and gloo's first use
    r = domain.get_local_rank("domain")
    out = _tree_paths(Z, dev, domain, r, world)
    out += _vdpf_paths(Z, dev, parties, r, world)
    out.append(_pir_path(Z, dev, domain, r, world))
    out.append(_data_path(Z, dev, data, r, world))
    out.append(_vdmpf_path(Z, dev, data, r, world))
    return out


def mesh2d_rank(rank: int, world: int, dev_type: str, Z: dict) -> list:
    """7f. One of 4 ranks of a 2 x 2 ("data", "domain") mesh: MESH2D_KEYS
    DPF keys at MESH2D_BITS (Uint(32), ChaCha) made by Gen, sharded on
    "data", each key's EvalAll sharded on "domain", both parties counted
    and timed; each rank's [keys/2, 2^(n-1), 4] block against the
    unsharded card EvalAll of its keys, reconstructed."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups
    from fss_tpu_torch.api import Dpf
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.prg.chacha import ChaCha
    from torch.distributed.device_mesh import init_device_mesh
    dev = _rank_device(dev_type)
    m = init_device_mesh(dev_type, (2, 2), mesh_dim_names=("data",
                                                            "domain"))
    pm.replicate(m, [0, 0, 0, 0])  # DTensor's and gloo's first use
    i, j = m.get_coordinate()
    n, B = Z["MESH2D_BITS"], Z["MESH2D_KEYS"]
    g = groups.Uint(32)
    d = Dpf(n, g, ChaCha(2, NONCE), device=dev)
    rng = np.random.default_rng(74)
    s0s = blk.words(rng.integers(0, 2**32, size=(B, 2, 4), dtype=np.uint64),
                    dev)
    alphas = rng.integers(0, 1 << n, size=B, dtype=np.uint64)
    betas = blk.words(rng.integers(0, 2**32, size=(B, 4), dtype=np.uint64),
                      dev)
    ms = []

    def run():
        cws = pm.shard_batch(m, d.gen_batch(s0s, alphas, betas))
        ys = []
        for p in (0, 1):
            y, t = _timed(dev, lambda p=p: pm.dpf_eval_all_sharded(
                d.prg, g, n, p, pm.shard_batch(m, s0s[:, p]), cws, m))
            ys.append(y)
            ms.append(t)
        return cws.to_local(), ys

    (cws, ys), launches = _counted(dev, run)
    half, keys = (1 << n) // 2, B // 2
    mine = range(i * keys, (i + 1) * keys)
    same = all(torch.equal(ys[p].to_local()[q], d.eval_all(
        p, s0s[k, p], cws[q])[j * half:(j + 1) * half])
        for p in (0, 1) for q, k in enumerate(mine))
    x = torch.arange(j * half, (j + 1) * half, device=dev)
    rec = g.add(g.from_block(ys[0].to_local()),
                g.from_block(ys[1].to_local()))[..., 0]
    want = torch.stack([torch.where(x == int(alphas[k]), betas[k, 0], 0)
                        for k in mine])
    return [_record("mesh2d", launches, ("dpf_gen", "dpf_eval_all"),
                    {"same_as_unsharded": same,
                     "layout": [str(s) for s in ys[0].placements]
                     == ["S(0)", "S(1)"] and tuple(ys[0].shape) == (
                         B, 1 << n, 4),
                     "reconstructs": torch.equal(rec, want)},
                    coordinate=[i, j], in_bits=n, keys=B, ms=ms)]


def nccl_path(dev, Z: dict) -> list:
    """7g. One rank over NCCL, the backend for one rank a card: the DPF's
    and Grotto's sharded EvalAll at SHARD_BITS (Grotto's all_gather) and
    the PIR lookup (its all_reduce) through a 1-rank "domain" mesh, as
    7a and 7c check them."""
    import torch.distributed as dist
    from fss_tpu_torch.parallel import mesh as pm
    from fss_tpu_torch.parallel import spawn
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{spawn.free_port()}", rank=0,
        world_size=1)
    try:
        m = pm.make_mesh(axis_names=("domain",))
        pm.replicate(m, [0, 0, 0, 0])  # NCCL's first use
        backend = dist.get_backend(m.get_group("domain"))
        out = _tree_paths(Z, dev, m, 0, 1, ("dpf", "grotto"))
        out.append(_pir_path(Z, dev, m, 0, 1))
    finally:
        dist.destroy_process_group()
    for rec in out:
        rec["checks"]["backend_is_nccl"] = backend == "nccl"
        rec["exact"] = rec["exact"] and backend == "nccl"
    return out


def front_door_path(dev) -> list:
    """7h. The fss_crypto front door: crypto.Dpf(FRONT_BITS, "uint", prg)
    and crypto.Dcf(FRONT_BITS, "uint", prg) ("lt"), prg "chacha" then
    "aes128_mmo": Gen from CPU tensors, both parties' Eval of
    2^FRONT_LOG2_POINTS points given as CUDA tensors (shares back on the
    card) and EvalAll of a key at FRONT_EVAL_ALL_BITS, counted and timed;
    every share reconstructed, and FRONT_SAMPLE points of each held
    against the CPU front door (the kernels' plain versions)."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import crypto
    from fss_tpu_torch import groups
    g = groups.Uint(32)
    rng = np.random.default_rng(75)
    beta = torch.tensor([0x600DF00D, 0, 0, 0], dtype=torch.int32)
    out = []
    for prg in ("chacha", "aes128_mmo"):
        for cls in ("Dpf", "Dcf"):
            F = getattr(crypto, cls)
            d = F(FRONT_BITS, "uint", prg, device=dev)
            d_all = F(FRONT_EVAL_ALL_BITS, "uint", prg, device=dev)
            s0s = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 4),
                                                dtype=np.int32))
            alpha = int(rng.integers(0, 1 << FRONT_BITS))
            alpha_all = int(rng.integers(0, 1 << FRONT_EVAL_ALL_BITS))
            x = blk.words(rng.integers(0, 1 << FRONT_BITS,
                                       size=1 << FRONT_LOG2_POINTS,
                                       dtype=np.uint64), dev)
            x[:64] = alpha
            ms = {}

            def run():
                cws = d.gen(s0s, alpha, beta)
                cws_all = d_all.gen(s0s, alpha_all, beta)
                ys, alls = [], []
                for p in (0, 1):
                    y, ms[f"eval_{p}"] = _timed(dev, lambda p=p: d.eval(
                        p, s0s[p].to(dev), cws.to(dev), x))
                    a, ms[f"eval_all_{p}"] = _timed(
                        dev, lambda p=p: d_all.eval_all(p, s0s[p], cws_all))
                    ys.append(y)
                    alls.append(a)
                return cws, cws_all, ys, alls

            (cws, cws_all, ys, alls), launches = _counted(dev, run)

            def want(xs, a):
                hit = xs < a if cls == "Dcf" else xs == a
                return torch.where(hit, 0x600DF00D, 0).to(torch.int32)

            rec = g.add(g.from_block(ys[0]), g.from_block(ys[1]))[:, 0]
            rec_all = g.add(g.from_block(alls[0]), g.from_block(alls[1]))
            xa = torch.arange(1 << FRONT_EVAL_ALL_BITS)
            sx = x[:FRONT_SAMPLE].cpu()
            sa = torch.from_numpy(rng.integers(
                0, 1 << FRONT_EVAL_ALL_BITS, size=FRONT_SAMPLE))
            cpu = F(FRONT_BITS, "uint", prg, device="cpu")
            cpu_all = F(FRONT_EVAL_ALL_BITS, "uint", prg, device="cpu")
            plain = all(
                torch.equal(cpu.eval(p, s0s[p], cws, sx),
                            ys[p][:FRONT_SAMPLE].cpu())
                and torch.equal(cpu_all.eval(p, s0s[p], cws_all,
                                             sa.to(torch.int32)),
                                alls[p][sa])
                for p in (0, 1))
            sfx = "_aes" if prg == "aes128_mmo" else ""
            s = cls.lower()
            out.append(_record(
                f"front_door_{s}_{prg}", launches,
                tuple(f"{s}_{k}{sfx}" for k in ("gen", "eval", "eval_all")),
                {"eval_on_card": all(y.device.type == "cuda" for y in ys),
                 "eval_reconstructs": torch.equal(rec.cpu(),
                                                  want(x.cpu(), alpha)),
                 "eval_all_reconstructs": torch.equal(rec_all[:, 0],
                                                      want(xa, alpha_all)),
                 "sample_vs_plain": plain},
                points=x.numel(), eval_all_bits=FRONT_EVAL_ALL_BITS,
                sample=FRONT_SAMPLE, ms=ms))
    return out


def phase7(kind: str, power_limit: str, backend: str = "gloo",
           ranks: int = SHARD_RANKS):
    """7. The multi-device paths and the front door, each counted and
    checked on the card: ``ranks`` ranks over ``backend`` (7a-7e:
    ``shard_rank``; gloo: sharing the card, as ``chip_smoke.py`` runs it;
    NCCL: one a card, ``scripts/torch_multi_device.py --nccl``), 4 ranks
    on a 2 x 2 mesh (7f: ``mesh2d_rank``), one rank over NCCL in this
    process (7g) and the front door (7h). One line a path, each rank's ms
    and launches beside the card's name and power limit. Returns (every
    path exact and through its kernels, the launches of all of them
    summed over ranks)."""
    from fss_tpu_torch.parallel import spawn
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    Z = phase7_sizes()
    groups_of_records = []
    world_s = {}
    # The ranks share the card with this process: hand them its cache.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("phase7_start", memory=_memory())
    for name, count, fn in (("shard", ranks, shard_rank),
                            ("mesh2d", 4, mesh2d_rank)):
        t = time.perf_counter()
        try:
            res = spawn.run(fn, count, ("cuda", Z), backend=backend,
                            wait_s=900)
        except RuntimeError as e:
            e.add_note(f"phase 7 {name}: memory after the ranks "
                       f"{json.dumps(_memory())}")
            raise
        world_s[name] = round(time.perf_counter() - t, 1)
        groups_of_records += [(backend, list(recs)) for recs in zip(*res)]
    t = time.perf_counter()
    groups_of_records += [("nccl", [rec]) for rec in nccl_path(dev, Z)]
    world_s["nccl"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    groups_of_records += [("in-process", [rec])
                          for rec in front_door_path(dev)]
    world_s["front_door"] = round(time.perf_counter() - t, 1)
    totals, ok = {}, True
    for how, recs in groups_of_records:
        for rec in recs:
            for k, v in rec["launches"].items():
                totals[k] = totals.get(k, 0) + v
        path_ok = all(r["exact"] and r["launched"] for r in recs)
        ok = ok and path_ok
        note = ("one rank" if len(recs) == 1 else SHARED_CARD
                if how == "gloo" else "one rank a card")
        log("multi_device", path=recs[0]["path"], backend=how,
            ranks=len(recs), card=kind, power_limit=power_limit, note=note,
            ok=path_ok, per_rank=recs)
    log("phase7", seconds=round(time.perf_counter() - t0, 1),
        parts_s=world_s, launches=totals, memory=_memory(), ok=ok)
    return ok, totals


# ---------------------------------------------------------------------------
# Phase 8: the sample twins, profiling and the host engine
# ---------------------------------------------------------------------------

SAMPLE_TWINS = ("torch_dpf_dcf_basic", "torch_dpf_batched_gpu",
                "torch_dpf_packed_pipeline", "torch_vdpf_vdmpf_verified",
                "torch_pir_gpu", "torch_dcf_mod_groups")
NATIVE_BITS = 16            # the host engine against the card: Gen and
NATIVE_LOG2_KEYS = 12       # Eval of 4096 keys at 16 bits, EvalAll of one
NATIVE_EVAL_ALL_BITS = 20   # key at 20 bits, a VDPF at 4096 points, the
NATIVE_VDPF_POINTS = 4096   # PRP at the VDMPF bench's domain
NATIVE_RATE_LOG2_KEYS = 16  # the host rate: dpf_eval_batch of 2^16 keys
NATIVE_RATE_REPS = 3
PROFILE_DIR = REPO / "build" / "profile_trace"  # git-ignored
DPF_EVAL_SYMBOL = "dpf_eval_kernel"  # csrc/dpf_eval.cu


def sample_twins(dev) -> list:
    """8a. Each sample twin's ``main`` on ``dev``, its output kept, the
    launch counts zeroed before it and read after: one record a twin. A
    twin that raises is recorded with its traceback."""
    from fss_tpu_torch import _build
    recs = []
    for name in SAMPLE_TWINS:
        mod = importlib.import_module(f"samples.{name}")
        out, error = io.StringIO(), None
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                mod.main(dev.type)
        except Exception:  # recorded; the phase fails
            error = traceback.format_exc()
        counts = {k: _build.launches[k] for k in mod.KERNELS}
        lines = out.getvalue().splitlines()
        ok = (error is None and all(counts.values()) and bool(lines)
              and lines[-1].endswith("OK"))
        recs.append({"sample": f"samples/{name}.py", "ok": ok,
                     "seconds": round(time.perf_counter() - t0, 3),
                     "launches": counts, "output": lines, "error": error})
    return recs


def profile_check(ev, dev) -> dict:
    """8b. ``profile_trace`` around one call of ``ev``: the trace it wrote
    must hold the DPF Eval kernel under its symbol, and the runtime call
    that launched it (by ``correlation``) must lie inside the span
    ``launch.dpf_eval`` on the trace's clock: the check that the spans'
    clock and the profiler's agree. Logs the call's offsets from the
    span's start and to its end, us."""
    from fss_tpu_torch.utils import profile_trace
    ev()
    torch.cuda.synchronize()
    log_dir = PROFILE_DIR / f"run-{os.getpid()}-{time.time_ns()}"
    with profile_trace(log_dir, device=dev.type):
        ev()
    (trace,) = log_dir.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if DPF_EVAL_SYMBOL in e.get("name", "")]
    corr = {e.get("args", {}).get("correlation") for e in ours}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") in corr]
    spans = [e for e in events if e.get("cat") == "port_span"
             and e.get("name") == "launch.dpf_eval"]
    offsets = [[c["ts"] - s["ts"], s["ts"] + s["dur"] - c["ts"] - c["dur"]]
               for c in calls for s in spans]
    inside = bool(calls) and len(spans) == 1 and all(
        a >= 0 and b >= 0 for a, b in offsets)
    return {"trace": str(trace.relative_to(REPO)),
            "trace_bytes": trace.stat().st_size, "events": len(events),
            "kernel_events": sorted({e["name"] for e in kernels}),
            "dpf_eval_symbol_found": bool(ours),
            "dpf_eval_trace_us": [e.get("dur") for e in ours],
            "launch_calls": [c["name"] for c in calls],
            "port_spans": sorted(e["name"] for e in events
                                 if e.get("cat") == "port_span"),
            "launch_in_span": inside,
            "launch_offsets_us": offsets,
            "ok": bool(ours) and inside}


def host_vs_card(eng, dev, rng) -> dict:
    """8c. The host engine and the card on the same inputs, byte for byte:
    {check: equal}. DPF, DCF (lt) and Half-Tree Gen and Eval of
    2^NATIVE_LOG2_KEYS keys at NATIVE_BITS (key i at point i, half the
    points at alpha) and EvalAll of one key at NATIVE_EVAL_ALL_BITS, each
    with ChaCha and AES-128-MMO; a VDPF (ChaCha, BLAKE3): Gen, eval_batch
    of both parties at NATIVE_VDPF_POINTS points and the proof; the PRP
    over the VDMPF bench's domain against its permutation table."""
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups, native
    from fss_tpu_torch.api import Dcf, Dpf, HalfTreeDpf, Vdpf
    from fss_tpu_torch.hash import Blake3
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.prp.feistel import Aes128Feistel

    g, u32 = groups.Uint(32), (native.GROUP_UINT, 32)
    n, keys, ea = NATIVE_BITS, 1 << NATIVE_LOG2_KEYS, NATIVE_EVAL_ALL_BITS
    s0s = rng.integers(0, 2**32, size=(keys, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**n, size=keys, dtype=np.uint32)
    betas = rng.integers(0, 2**32, size=(keys, 4), dtype=np.uint32)
    xs = rng.integers(0, 2**n, size=keys, dtype=np.uint32)
    xs[::2] = alphas[::2]
    hk = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    ea_alpha = np.array([rng.integers(0, 2**ea)], dtype=np.uint32)

    def equal(card, host) -> bool:
        if isinstance(card, tuple):
            return all(equal(c, h) for c, h in zip(card, host))
        return torch.equal(card.cpu(), host)

    checks = {}
    for prg_name, kind in (("chacha", native.PRG_CHACHA),
                           ("aes", native.PRG_AES128_MMO)):
        def prg(mul):
            if kind == native.PRG_CHACHA:
                return ChaCha(mul, NONCE), {"nonce": NONCE}
            return AesMmo(mul, AES_KEYS[:mul]), {"aes_keys": AES_KEYS[:mul]}

        for scheme in ("dpf", "dcf"):
            P, kw = prg(2 if scheme == "dpf" else 4)
            pred = ("lt",) if scheme == "dcf" else ()
            d, e = ((Dpf(b, g, P, device=dev) if scheme == "dpf" else
                     Dcf(b, g, P, pred="lt", device=dev)) for b in (n, ea))
            gen_batch, eval1, eval_all = (getattr(eng, f"{scheme}_{f}") for f
                                          in ("gen_batch", "eval",
                                              "eval_all"))
            cws = gen_batch(n, kind, *u32, *pred, s0s, alphas, betas, **kw)
            tag = f"{scheme} {prg_name}"
            checks[f"{tag} gen"] = equal(d.gen_batch(s0s, alphas, betas),
                                         cws)
            for p in (0, 1):
                if scheme == "dpf":
                    host = eng.dpf_eval_batch(n, kind, *u32, p, s0s[:, p],
                                              cws, xs, **kw)
                else:
                    host = torch.cat([eval1(n, kind, *u32, p, s0s[i, p],
                                            cws[i], xs[i:i + 1], **kw)
                                      for i in range(keys)])
                checks[f"{tag} eval party {p}"] = equal(
                    d.eval(p, s0s[:, p], cws, xs), host)
            key = gen_batch(ea, kind, *u32, *pred, s0s[:1], ea_alpha,
                            betas[:1], **kw)
            checks[f"{tag} gen at {ea} bits"] = equal(
                e.gen_batch(s0s[:1], ea_alpha, betas[:1]), key)
            checks[f"{tag} eval_all {ea} bits"] = equal(
                e.eval_all(1, s0s[0, 1], key[0]),
                eval_all(ea, kind, *u32, 1, s0s[0, 1], key[0], **kw))

        P, kw = prg(1)
        d, e = (HalfTreeDpf(b, g, P, hash_key=hk, device=dev)
                for b in (n, ea))
        cws, ocw = eng.ht_gen_batch(n, kind, *u32, hk, s0s, alphas, betas,
                                    **kw)
        tag = f"half_tree {prg_name}"
        checks[f"{tag} gen"] = equal(d.gen_batch(s0s, alphas, betas),
                                     (cws, ocw))
        for p in (0, 1):
            host = torch.cat([eng.ht_eval(n, kind, *u32, p, hk, s0s[i, p],
                                          cws[i], ocw[i], xs[i:i + 1], **kw)
                              for i in range(keys)])
            checks[f"{tag} eval party {p}"] = equal(
                d.eval(p, s0s[:, p], cws, ocw, xs), host)
        key = eng.ht_gen_batch(ea, kind, *u32, hk, s0s[:1], ea_alpha,
                               betas[:1], **kw)
        checks[f"{tag} gen at {ea} bits"] = equal(
            e.gen_batch(s0s[:1], ea_alpha, betas[:1]), key)
        checks[f"{tag} eval_all {ea} bits"] = equal(
            e.eval_all(1, s0s[0, 1], key[0][0], key[1][0]),
            eng.ht_eval_all(ea, kind, *u32, 1, hk, s0s[0, 1], key[0][0],
                            key[1][0], **kw))

    iv = np.asarray(VDPF_IV, dtype="<u4").tobytes()
    vd = Vdpf(n, g, ChaCha(2, NONCE), hashes=Blake3(VDPF_IV), device=dev)
    head = (n, native.PRG_CHACHA, 1, iv, *u32)
    key = eng.vdpf_gen(*head, s0s[0], int(alphas[0]), betas[0], nonce=NONCE)
    card = vd.gen(s0s[0], int(alphas[0]), betas[0])
    checks["vdpf blake3 gen"] = (equal(card[:3], key[:3])
                                 and int(card[3]) == key[3])
    pxs = rng.integers(0, 2**n, size=NATIVE_VDPF_POINTS, dtype=np.uint32)
    pxs[::64] = alphas[0]
    for p in (0, 1):
        ys, pts = eng.vdpf_eval_batch(*head, p, s0s[0, p], *key[:3], pxs,
                                      nonce=NONCE)
        cys, cpts = vd.eval(p, s0s[0, p], *card[:3], pxs)
        checks[f"vdpf blake3 eval_batch party {p}"] = equal((cys, cpts),
                                                            (ys, pts))
        checks[f"vdpf blake3 prove party {p}"] = equal(
            vd.prove(cpts, card[1]), eng.vdpf_prove(1, iv, pts, key[1]))

    sigma = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    domain = 3 << VDMPF_BITS  # the VDMPF bench's n * kappa
    table = Aes128Feistel(sigma, domain).permutation_table(dev)
    checks[f"prp_permu_batch over {domain}"] = equal(
        blk.u64(table), eng.prp_permu_batch(sigma, domain,
                                            torch.arange(domain)))
    return checks


def host_rate(eng) -> dict:
    """8d. The host engine's ``dpf_eval_batch`` of 2^NATIVE_RATE_LOG2_KEYS
    keys at NATIVE_BITS (ChaCha mul=2, Uint(32)): evals/s over
    NATIVE_RATE_REPS calls after one, on the host's clock."""
    from fss_tpu_torch import native
    rng = np.random.default_rng(15)
    n, keys = NATIVE_BITS, 1 << NATIVE_RATE_LOG2_KEYS
    head = (n, native.PRG_CHACHA, native.GROUP_UINT, 32)
    s0s = rng.integers(0, 2**32, size=(keys, 2, 4), dtype=np.uint32)
    alphas = rng.integers(0, 2**n, size=keys, dtype=np.uint32)
    cws = eng.dpf_gen_batch(*head, s0s, alphas,
                            rng.integers(0, 2**32, size=(keys, 4)),
                            nonce=NONCE)
    args = (*head, 0, torch.from_numpy(s0s[:, 0].copy().view(np.int32)),
            cws, torch.from_numpy(alphas.astype(np.int64)))
    eng.dpf_eval_batch(*args, nonce=NONCE)
    t0 = time.perf_counter()
    for _ in range(NATIVE_RATE_REPS):
        eng.dpf_eval_batch(*args, nonce=NONCE)
    ms = (time.perf_counter() - t0) / NATIVE_RATE_REPS * 1e3
    # The first processor's identity (a VM may report its model name as
    # "unknown": the vendor, family and model numbers name it then).
    cpu = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            if key.strip() in ("model name", "vendor_id", "cpu family",
                               "model", "stepping", "cpu MHz"):
                cpu[key.strip()] = value.strip()
    return {"keys": keys, "in_bits": n, "prg": "ChaCha mul=2",
            "group": "uint32", "ms": ms, "evals_per_s": keys / (ms / 1e3),
            "host_cpu": cpu, "host_cpus": os.cpu_count(),
            "engine_threads": 1, "flags": list(native.host_flags())}


def phase8(S, dev, kind: str, power_limit: str, native_build) -> tuple:
    """8. The six sample twins on the card (8a), ``profile_trace`` around
    one Eval of the DPF main path's 2^20 keys, its launch inside its span
    (8b), the host engine against the card (8c) and the host engine's
    rate (8d): one line each. ``S``:
    the DPF main path's state, with phase 6's ``eval_ms``; native_build:
    the future of the engine's g++ build, started in phase 2. Returns
    (every part held, the twins' launches summed by kernel)."""
    from fss_tpu_torch import native
    t0 = time.perf_counter()
    card = {"card": kind, "power_limit": power_limit}

    twins = sample_twins(dev)
    twins_ok = all(r["ok"] for r in twins)
    totals = {}
    for rec in twins:
        for k, v in rec["launches"].items():
            totals[k] = totals.get(k, 0) + v
    log("sample_twins", **card, ok=twins_ok, twins=twins)

    s0 = S["s0s"][:, 0].contiguous()

    def ev():
        return S["d"].eval(0, s0, S["cws"], S["xs"])

    prof = profile_check(ev, dev)
    log("profile_trace", **card, keys=S["nkeys"], in_bits=MAIN_BITS, **prof)

    phase6 = S["nkeys"] / (S["eval_ms"] / 1e3)

    t = time.perf_counter()
    so = native_build.result()
    eng = native.engine()
    checks = host_vs_card(eng, dev, np.random.default_rng(8))
    native_ok = all(checks.values())
    log("host_engine_vs_card", **card, library=so.name,
        build_wait_s=round(time.perf_counter() - t, 3), ok=native_ok,
        checks=checks)

    log("host_engine_rate", **card, **host_rate(eng),
        card_eval_per_s_2e20_keys=phase6)

    ok = twins_ok and prof["ok"] and native_ok
    log("phase8", seconds=round(time.perf_counter() - t0, 1),
        launches=totals, ok=ok)
    return ok, totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fss_tpu_torch import _build
    from fss_tpu_torch import block as blk
    from fss_tpu_torch import groups, native
    from fss_tpu_torch.api import DEFAULT_HASH_IV, Dcf, Dpf, HalfTreeDpf, Vdpf
    from fss_tpu_torch.hash import Blake3, Sha256
    from fss_tpu_torch.ops import (blake3_cuda, dcf_cuda, dpf_cuda,
                                   eval_all_cuda, ht_cuda, sha256_cuda,
                                   vdpf_cuda)
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha
    from fss_tpu_torch.schemes import dcf as plain_dcf
    from fss_tpu_torch.schemes import dpf as plain_dpf
    from fss_tpu_torch.schemes import half_tree_dpf as plain_ht
    from fss_tpu_torch.schemes import vdpf as plain_vdpf

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    CH = {m: ChaCha(m, NONCE) for m in (1, 2, 4)}
    AES = {m: AesMmo(m, AES_KEYS[:m]) for m in (1, 2, 4)}

    def words(shape, bits=32):
        return blk.words(rng.integers(0, 2**bits, size=shape,
                                      dtype=np.uint64), dev)

    def plain_xor(hashes):
        return functools.partial(vdpf_cuda.xor_hash_plain, hashes)

    def plain_h64(hashes):
        return functools.partial(vdpf_cuda.hash64_plain, hashes)

    # 1. device ------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * LANES_PER_SM_CLOCK * max_mhz * 1e6
    lds_per_s = sms * LDS_PER_SM_CLOCK * max_mhz * 1e6
    log("device", kind=kind, nvidia_smi=smi, sms=sms, max_sm_mhz=max_mhz,
        torch=torch.__version__, cuda=torch.version.cuda)

    def bound(ops: float, nbytes: float, lds: float = 0):
        """The least time (ms) for ``ops`` 32-bit ALU instructions, ``lds``
        shared-memory loads and ``nbytes`` of device memory, and what sets
        it: "operations" (ALU or LDS issue) or "bytes"."""
        t_ops = max(ops / int_ops_per_s, lds / lds_per_s)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    # 2. build -------------------------------------------------------------
    # The host engine's g++ build (phase 8) runs beside nvcc's.
    native_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    native_build = native_pool.submit(native.build)
    native_pool.shutdown(wait=False)
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    usage = {name: ptxas_usage(text) for name, text in reports.items()}
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = {name: sass_usage(cuobjdump, _build.library(name),
                             pipes=name in ("blake3", "sha256", "ht_eval"))
            for name in ("blake3", "sha256", "vdpf_eval", "dpf_eval",
                         "dcf_eval", "ht_eval", "dpf_eval_all",
                         "dcf_eval_all", "ht_eval_all", "dpf_gen",
                         "dcf_gen", "feistel")}
    sass["sha256 chain roles"] = chain_role_usage(
        _build.nvcc(), cuobjdump, _build.CSRC, _build.BUILD_DIR)
    sass["blake3 chain roles"] = chain_role_usage(
        _build.nvcc(), cuobjdump, _build.CSRC, _build.BUILD_DIR,
        BLAKE3_CHAIN_ROLES_SRC, "blake3_chain_roles")
    latencies = alu_latencies(_build.nvcc(), cuobjdump, _build.BUILD_DIR)
    log("build", seconds=round(build_s, 3), nvcc=_build.nvcc(), ptxas=usage,
        sass=sass, sass_fields=["instructions", "alu", "lds", "alu_pipe",
                                "imad", "viadd", "ldg"],
        hash_alu={f"{h} {u}": hash_alu(h, u) for h in ("blake3", "sha256")
                  for u in ("xor_hash", "hash64")},
        aes_block={"alu": AES_ALU, "lds": AES_LDS},
        latency_clocks=latencies)

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

    def _x4(xs):
        """[B] x words -> [B, 4] lanes."""
        out = torch.zeros((xs.shape[0], 4), dtype=torch.int32, device=dev)
        out[:, 0] = xs
        return out

    # One group per accumulator mode of the DCF kernels.
    dcf_groups = {"xor": groups.Bytes(), "wrap": groups.Uint(32),
                  "mod64": groups.Uint(64, (1 << 61) - 1),
                  "mod128": groups.Uint(128, 1 << 127),
                  "mod128np": groups.Uint(128, (1 << 127) - 1)}
    hash_key = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    hk = blk.words(list(hash_key), dev)
    iv = tuple(int(w) for w in rng.integers(0, 2**32, size=8))
    skey = tuple(int(w) for w in rng.integers(0, 2**32, size=4))
    vdpf_hashes = {"blake3": Blake3(iv), "sha256": Sha256(skey)}
    vg = groups.Uint(32)

    def eval_all_checks(P, tag):
        """The DPF, DCF and Half-Tree EvalAll kernels against their plain
        versions on CHECK_PLANS for every group kind and both parties, the
        DPF's seeds epilogue beside them, and the breadth-first schemes at
        8 bits."""
        plans = [(n, most, g) for n, most in CHECK_PLANS
                 for g in dcf_groups.values()]
        plans += [(n, eval_all_cuda.SUBTREE_LEVELS, groups.Uint(32))
                  for n in CHECK_WIDE_BITS]
        for n, most, g in plans:
            s0s, beta = words((1, 2, 4), 32), words((1, 4))
            alpha = blk.pack_inputs([int(rng.integers(0, 2**n))], n, dev)
            cws = plain_dpf.gen(P[2], g, n, s0s, alpha, beta)[0]
            dcws = plain_dcf.gen(P[4], g, n, "lt", s0s, alpha, beta)[0]
            hcws, hocw = (k[0] for k in plain_ht.gen(P[1], g, n, hk, s0s,
                                                     alpha, beta))
            label = f"{tag} n={n} most={most} {g.name}"
            for party in (0, 1):
                s0 = s0s[0, party]
                hargs = (P[1], g, n, party, hash_key, s0, hcws, hocw, most)
                hgot = eval_all_cuda.ht_eval_all(*hargs)
                hwant = eval_all_cuda.ht_eval_all_plain(*hargs)
                got = eval_all_cuda.eval_all(P[2], g, n, party, s0, cws,
                                             most)
                want = eval_all_cuda.eval_all_plain(P[2], g, n, party, s0,
                                                    cws, most)
                dgot = eval_all_cuda.dcf_eval_all(P[4], g, n, party, s0,
                                                  dcws, most)
                dwant = eval_all_cuda.dcf_eval_all_plain(P[4], g, n, party,
                                                         s0, dcws, most)
                if n == 8:
                    want_bf = plain_dpf.eval_all(P[2], g, n, party, s0, cws)
                    dwant_bf = plain_dcf.eval_all(P[4], g, n, party, s0,
                                                  dcws)
                    checks.append((f"{label} dpf_eval_all breadth-first "
                                   f"party={party}", same(want, want_bf)))
                    checks.append((f"{label} dcf_eval_all breadth-first "
                                   f"party={party}", same(dwant, dwant_bf)))
                    hwant_bf = plain_ht.eval_all(P[1], g, n, party, hk, s0,
                                                 hcws, hocw)
                    checks.append((f"{label} ht_eval_all breadth-first "
                                   f"party={party}", same(hwant, hwant_bf)))
                checks.append((f"{label} dpf_eval_all party={party}",
                               same(got, want)))
                checks.append((f"{label} dcf_eval_all party={party}",
                               same(dgot, dwant)))
                checks.append((f"{label} ht_eval_all party={party}",
                               same(hgot, hwant)))
                if isinstance(g, groups.Bytes):  # the VDPF's epilogue
                    got = eval_all_cuda.expand_leaves(P[2], n, party, s0,
                                                      cws[:n], most)
                    want = eval_all_cuda.expand_leaves_plain(
                        P[2], n, party, s0, cws[:n], most)
                    checks.append((f"{label} dpf_eval_all seeds "
                                   f"party={party}", same(got, want)))

    def tree_checks(P, tag, wide, vdpf_ea_bits):
        """Every tree kernel with the PRGs ``P`` ({mul: PRG}) against its
        plain version: walks at 16 and ``wide`` bits, Gen at 16 and 48,
        EvalAll (eval_all_checks; the VDPF's at ``vdpf_ea_bits``)."""
        for n in (16, wide):
            s0s, betas = words((B, 2, 4)), words((B, 4))
            alphas = domain(words((B, 4)), n)
            xs = alphas.clone()
            xs[1::2, 0] ^= 1
            xs = kernel_inputs(xs, n)
            wire = dpf_cuda.gen_batch(P[2], groups.Uint(32), n, s0s,
                                      kernel_inputs(alphas, n), betas)
            cws_p, _ = dpf_cuda.pack_keys(wire, n)
            cases = {
                "wire": (s0s[:, 0].contiguous(), wire, False),
                "packed": (s0s[:, 1].contiguous(), cws_p, True),
                "broadcast": (s0s[0, 0].contiguous(), wire[0].contiguous(),
                              False),
            }
            for label, (s0, cws, packed) in cases.items():
                got = dpf_cuda.eval_packed(s0, cws, xs, n, 1, P[2],
                                           packed=packed)
                want = dpf_cuda.eval_packed_plain(s0, cws, xs, n, 1, P[2],
                                                  packed=packed)
                checks.append((f"{tag} dpf_eval n={n} {label}",
                               same(got, want)))
        for n in (16, 48):
            s0s = words((B, 2, 4))
            alphas = kernel_inputs(domain(words((B, 4)), n), n)
            for layout in ("wire", "packed"):
                got = dpf_cuda.gen_packed(s0s, alphas, n, P[2],
                                          layout=layout)
                want = dpf_cuda.gen_packed_plain(s0s, alphas, n, P[2],
                                                 layout=layout)
                checks.append((f"{tag} dpf_gen n={n} {layout}",
                               same(got, want)))
        # The output CW in the Gen kernel, for every group kind.
        for n in (1, 16, 128):
            s0s, betas = words((B, 2, 4)), words((B, 4))
            alphas = kernel_inputs(domain(words((B, 4)), n), n)
            for g in dcf_groups.values():
                for layout in ("wire", "packed"):
                    args = (s0s, alphas, n, P[2], layout)
                    got = dpf_cuda.gen_packed(*args, betas=betas, group=g)
                    want = dpf_cuda.gen_packed_plain(*args, betas=betas,
                                                     group=g)
                    checks.append((f"{tag} dpf_gen output cw {g.name} "
                                   f"n={n} {layout}", same(got, want)))
        eval_all_checks(P, tag)

        for mode, g in dcf_groups.items():
            vmask = dcf_cuda.value_mask(g)
            for n in (16, wide):
                s0s, betas = words((B, 2, 4)), words((B, 4))
                alphas = domain(words((B, 4)), n)
                xs = alphas.clone()
                xs[1::2, 0] ^= 1
                xs = kernel_inputs(xs, n)
                wire = dcf_cuda.gen_batch(P[4], g, n, "lt", s0s,
                                          kernel_inputs(alphas, n), betas)
                cases = {
                    "wire": (s0s[:, 1].contiguous(), wire),
                    "broadcast": (s0s[0, 1].contiguous(),
                                  wire[0].contiguous()),
                }
                for label, (s0, cws) in cases.items():
                    got = dcf_cuda.eval_packed(s0, cws, xs, n, 1, P[4], mode,
                                               vmask)
                    want = dcf_cuda.eval_packed_plain(s0, cws, xs, n, 1,
                                                      P[4], mode, vmask)
                    checks.append((f"{tag} dcf_eval {mode} n={n} {label}",
                                   same(got, want)))
            for n in (1, 16, 48):
                s0s, betas = words((B, 2, 4)), words((B, 4))
                alphas = kernel_inputs(domain(words((B, 4)), n), n)
                for pred in ("lt", "gt"):
                    got = dcf_cuda.gen_packed(s0s, alphas, betas, n, P[4],
                                              pred, g)
                    want = dcf_cuda.gen_packed_plain(s0s, alphas, betas, n,
                                                     P[4], pred, g)
                    checks.append((f"{tag} dcf_gen {mode} n={n} {pred}",
                                   same(got, want)))

        for n in (16, wide):
            s0s, betas = words((B, 2, 4)), words((B, 4))
            alphas = domain(words((B, 4)), n)
            xs = alphas.clone()
            xs[1::2, 0] ^= 1
            xs = kernel_inputs(xs, n)
            wire, _ = ht_cuda.gen_batch(P[1], groups.Uint(32), n, hash_key,
                                        s0s, kernel_inputs(alphas, n), betas)
            # Wire rows (AES: the TMA ring), one broadcast key, wire rows
            # at a 4-byte offset (the wrapper's aligned copy), and x as 4
            # lanes at 16 bits.
            flat = torch.empty(wire.numel() + 1, dtype=torch.int32,
                               device=dev)
            offset = flat[1:].view(wire.shape)
            offset.copy_(wire)
            cases = {
                "wire": (s0s[:, 1].contiguous(), wire, xs),
                "broadcast": (s0s[0, 1].contiguous(), wire[0].contiguous(),
                              xs),
                "offset": (s0s[:, 1].contiguous(), offset, xs),
            }
            if n <= 32:
                cases["x lanes=4"] = (s0s[:, 1].contiguous(), wire,
                                      _x4(xs))
            for label, (s0, cws, xs_) in cases.items():
                for party in (0, 1):
                    got = ht_cuda.eval_packed(s0, cws, xs_, n, party, P[1],
                                              hash_key)
                    want = ht_cuda.eval_packed_plain(s0, cws, xs_, n, party,
                                                     P[1], hash_key)
                    checks.append((f"{tag} ht_eval n={n} {label} "
                                   f"party={party}", same(got, want)))
        for n in (1, 16, wide):
            s0s = words((B, 2, 4))
            lanes = domain(words((B, 4)), n)
            for width in ((1, 4) if n <= 32 else (4,)):
                alphas = lanes if width == 4 else lanes[:, 0].contiguous()
                got = ht_cuda.gen_packed(s0s, alphas, n, P[1], hash_key)
                want = ht_cuda.gen_packed_plain(s0s, alphas, n, P[1],
                                                hash_key)
                checks.append((f"{tag} ht_gen n={n} alpha lanes={width}",
                               same(got, want)))
        # The output CW in the Gen kernel, for every group kind: against
        # the output CW of the plain Gen's leaves (gen_packed_plain with
        # betas, without a plain Gen a group).
        for n in (1, 16, 128):
            s0s, betas = words((B, 2, 4)), words((B, 4))
            lanes = domain(words((B, 4)), n)
            for width in ((1, 4) if n <= 32 else (4,)):
                alphas = lanes if width == 4 else lanes[:, 0].contiguous()
                cws, leaf0, leaf1 = ht_cuda.gen_packed_plain(
                    s0s, alphas, n, P[1], hash_key)
                for g in dcf_groups.values():
                    got = ht_cuda.gen_packed(s0s, alphas, n, P[1], hash_key,
                                             betas=betas, group=g)
                    want = (cws, plain_ht.output_cw(g, leaf0, leaf1, betas))
                    checks.append((f"{tag} ht_gen output cw {g.name} n={n} "
                                   f"alpha lanes={width}", same(got, want)))
        # The fused VDPF eval, Gen (DPF Gen levels into VDPF rows + H), and
        # the DPF Gen's VDPF rows alone.
        for n in (16, wide):
            s0s, betas = words((B, 2, 4)), words((B, 4))
            lanes = domain(words((B, 4)), n)
            xs = lanes.clone()
            xs[1::2, 0] ^= 1
            xs = kernel_inputs(xs, n)
            alphas = kernel_inputs(lanes, n)
            got = dpf_cuda.gen_packed(s0s, alphas, n, P[2], ocw_row=False)
            want = dpf_cuda.gen_packed_plain(s0s, alphas, n, P[2],
                                             ocw_row=False)
            checks.append((f"{tag} dpf_gen n={n} vdpf rows",
                           same(got, want)))
            for name, hashes in vdpf_hashes.items():
                keys = vdpf_cuda.gen_batch(P[2], hashes, vg, n, s0s, alphas,
                                           betas)
                checks.append((f"{tag} vdpf gen {name} n={n}", same(
                    keys, plain_vdpf.gen(P[2], plain_xor(hashes), vg, n, s0s,
                                         lanes, betas))))
                cws = keys[0]
                for party in (0, 1):
                    cases = {
                        "wire": (s0s[:, party].contiguous(), cws),
                        "broadcast": (s0s[0, party].contiguous(),
                                      cws[0].contiguous()),
                    }
                    for label, (s0, k) in cases.items():
                        got = vdpf_cuda.eval_packed(s0, k, xs, n, party,
                                                    P[2], hashes)
                        want = vdpf_cuda.eval_packed_plain(s0, k, xs, n,
                                                           party, P[2],
                                                           hashes)
                        checks.append((f"{tag} vdpf_eval {name} n={n} "
                                       f"{label} party={party}",
                                       same(got, want)))
        # VDPF EvalAll: the tree fold for both hashes; the chunked and
        # reference folds for BLAKE3 at 8 bits (their plain versions chain
        # one row at a time through the plain hash).
        for n in vdpf_ea_bits:
            for name, hashes in vdpf_hashes.items():
                s0s, beta = words((1, 2, 4)), words((1, 4))
                key = [t[0] for t in vdpf_cuda.gen_batch(
                    P[2], hashes, vg, n, s0s, blk.pack_inputs(
                        [int(rng.integers(0, 2**n))], n, dev), beta)][:3]
                folds = ("tree",) + (("chunked", "reference")
                                     if n <= 8 and name == "blake3" else ())
                for fold in folds:
                    for party in (0, 1):
                        got = eval_all_cuda.vdpf_eval_all(
                            P[2], hashes, vg, n, party, s0s[0, party], *key,
                            fold)
                        want = plain_vdpf.eval_all(
                            P[2], plain_xor(hashes), plain_h64(hashes), vg,
                            n, party, s0s[0, party], *key, fold)
                        checks.append((f"{tag} vdpf_eval_all {name} n={n} "
                                       f"{fold} party={party}",
                                       same(got, want)))

    tree_checks(CH, "chacha", 128, CHECK_VDPF_EVAL_ALL_BITS)
    tree_checks(AES, "aes", 48, CHECK_AES_EVAL_ALL_BITS)
    # The hash kernels on random rows, on the reference's primitive
    # vectors, and the flat proof chains on CHAIN_ROWS points.
    a_rows, b_rows, msgs = words((B, 4)), words((B, 4)), words((B, 4, 4))
    pts, cs0 = words((CHAIN_ROWS, 4, 4)), words((4, 4))
    prims = json.loads((GOLDEN / "primitives.json").read_text())
    for name, hashes in vdpf_hashes.items():
        checks.append((f"{name} xor_hash", same(
            vdpf_cuda.xor_hash(hashes, a_rows, b_rows),
            vdpf_cuda.xor_hash_plain(hashes, a_rows, b_rows))))
        checks.append((f"{name} hash64", same(
            vdpf_cuda.hash64(hashes, msgs),
            vdpf_cuda.hash64_plain(hashes, msgs))))
        checks.append((f"{name} chain {CHAIN_ROWS}", same(
            vdpf_cuda.prove(hashes, pts, cs0),
            vdpf_cuda.prove_plain(hashes, pts, cs0))))
        # The chain around its ring's size, and on rows at a 4-byte
        # offset (the producers' 4-byte loads).
        ring = (blake3_cuda if name == "blake3" else sha256_cuda).CHAIN_RING
        flat = words((16 * (CHAIN_ROWS + 37) + 1,))
        for rows in (0, 1, 2, ring - 1, ring, ring + 1, CHAIN_ROWS + 37):
            for off in (0, 1):
                p = flat[off:off + 16 * rows].view(rows, 4, 4)
                checks.append((f"{name} chain {rows} offset {4 * off}", same(
                    vdpf_cuda.prove(hashes, p, cs0),
                    vdpf_cuda.prove_plain(hashes, p, cs0))))
    # B-12 on points below 2^32 (the domain bit set and clear),
    # 128-bit points, and warps that mix both; N = 1 and N off the CTA's
    # multiple; rows at a 4-byte offset.
    sha = vdpf_hashes["sha256"]
    for rows in (1, 31, 130, B):
        for points in ("small", "wide", "mixed"):
            for off in (0, 1):
                ab = words((2, 4 * rows + 1))
                x, sd = (ab[i, off:off + 4 * rows].view(rows, 4)
                         for i in (0, 1))
                if points != "wide":
                    sel = torch.ones(rows, dtype=torch.bool, device=dev)
                    if points == "mixed":
                        sel[::7] = False
                    x[sel, 1:3] = 0
                    x[sel, 3] &= 1
                checks.append((f"sha256 xor_hash {points} rows={rows} "
                               f"offset {4 * off}", same(
                                   sha256_cuda.xor_hash(sha.key, x, sd),
                                   sha256_cuda.xor_hash_plain(sha.key, x,
                                                              sd))))
        for i, e in enumerate(prims[name]):
            h = type(hashes)(hexw(e["iv" if name == "blake3" else "key"]))
            x, sd = (blk.words(hexw(e[f]), dev)[None] for f in ("x", "s"))
            got = vdpf_cuda.xor_hash(h, x, sd)
            checks.append((f"{name} primitive {i} xor_hash",
                           raw(got) == bytes.fromhex(e["xor_hash"])
                           and same(got, vdpf_cuda.xor_hash_plain(h, x, sd))))
            m = blk.words(hexw(e["msg"]).reshape(1, 4, 4), dev)
            got = vdpf_cuda.hash64(h, m)
            checks.append((f"{name} primitive {i} hash64",
                           raw(got) == bytes.fromhex(e["hash"])
                           and same(got, vdpf_cuda.hash64_plain(h, m))))
    checks += feistel_checks(dev, rng, B)
    torch.cuda.synchronize()
    bad = [name for name, ok in checks if not ok]
    log("kernels", checked=len(checks),
        aes_checked=sum(name.startswith("aes ") for name, _ in checks),
        mismatches=bad)
    if bad:
        return 1

    # 4. golden vectors on the card ---------------------------------------
    gmap = {"bytes": groups.Bytes(), "uint32": groups.Uint(32),
            "uint64": groups.Uint(64),
            "uint127": groups.Uint(128, 1 << 127),
            "uint127m": groups.Uint(128, (1 << 127) - 1)}

    def golden_case(scheme, case, failures):
        n = case["in_bits"]
        if scheme == "dpf":
            d = Dpf(n, gmap[case["group"]], case_prg(case, 2))
        elif scheme == "dcf":
            d = Dcf(n, gmap[case["group"]], case_prg(case, 4), case["pred"])
        else:
            d = HalfTreeDpf(n, gmap[case["group"]], case_prg(case, 1),
                            hexw(case["hash_key"]))
        tag = (f"{scheme} {case['prg']}-{case['group']}-{n}-"
               f"{case.get('pred', '')}")
        s0s = np.stack([hexw(h) for h in case["s0s"]])
        key = d.gen(s0s, int(case["alpha"], 0), hexw(case["beta"]))
        # A Half-Tree key is (cws, ocw); Eval and EvalAll take both.
        key = key if scheme == "half_tree" else (key,)
        if raw(key[0]) != np.stack([hexw(r) for r in case["cws"]]).tobytes():
            failures.append(f"{tag} gen")
        if scheme == "half_tree" and raw(key[1]) != bytes.fromhex(
                case["ocw"]):
            failures.append(f"{tag} gen ocw")
        xs = [int(x, 0) for x in case["xs"]]
        for party in (0, 1):
            ys = d.eval(party, s0s[party], *key, xs)
            if raw(ys) != b"".join(bytes.fromhex(h)
                                   for h in case[f"ys{party}"]):
                failures.append(f"{tag} eval party{party}")
            if "eval_all_digest0" in case:
                full = raw(d.eval_all(party, s0s[party], *key))
                if (hashlib.sha256(full).hexdigest()
                        != case[f"eval_all_digest{party}"]):
                    failures.append(f"{tag} eval_all party{party}")

    def vdpf_golden_case(case, failures):
        """Gen bytes, ys and pi~ of both parties, prove_pi, and EvalAll's
        digest and proof with the reference fold."""
        n = case["in_bits"]
        if case["hash"] == "sha256":
            hashes = Sha256(hexw(case["hash_key"]))
        else:
            hashes = Blake3(np.concatenate([hexw(h)
                                            for h in case["blake3_iv"]]))
        d = Vdpf(n, gmap[case["group"]], case_prg(case, 2), hashes=hashes)
        tag = f"vdpf {case['prg']}-{case['hash']}-{case['group']}-{n}"
        s0s = np.stack([hexw(h) for h in case["s0s"]])
        cws, cs, ocw, fail = d.gen(s0s, int(case["alpha"], 0),
                                   hexw(case["beta"]))
        if (int(fail) or raw(cws) != np.stack(
                [hexw(r) for r in case["cws"]]).tobytes()
                or raw(cs) != b"".join(bytes.fromhex(h) for h in case["cs"])
                or raw(ocw) != bytes.fromhex(case["ocw"])):
            failures.append(f"{tag} gen")
        xs = [int(x, 0) for x in case["xs"]]
        for party in (0, 1):
            ys, pis = d.eval(party, s0s[party], cws, cs, ocw, xs)
            if raw(ys) != b"".join(bytes.fromhex(h)
                                   for h in case[f"ys{party}"]):
                failures.append(f"{tag} eval party{party}")
            if raw(pis) != b"".join(bytes.fromhex(h)
                                    for h in case[f"pi_tildes{party}"]):
                failures.append(f"{tag} pi_tildes party{party}")
            if raw(d.prove(pis, cs)) != bytes.fromhex(
                    case[f"prove_pi{party}"]):
                failures.append(f"{tag} prove party{party}")
            if "eval_all_digest0" in case:
                ys, pi = d.eval_all(party, s0s[party], cws, cs, ocw,
                                    "reference")
                if (hashlib.sha256(raw(ys)).hexdigest()
                        != case[f"eval_all_digest{party}"]
                        or raw(pi) != bytes.fromhex(
                            case[f"eval_all_pi{party}"])):
                    failures.append(f"{tag} eval_all party{party}")

    failures, counts = [], {}
    for scheme in ("dpf", "dcf", "half_tree", "vdpf", "grotto", "vdmpf"):
        golden = json.loads((GOLDEN / f"{scheme}.json").read_text())["cases"]
        for case in golden:
            key = f"{scheme} {case['prg']}"
            counts[key] = counts.get(key, 0) + 1
            if scheme == "vdpf":
                vdpf_golden_case(case, failures)
            elif scheme == "grotto":
                grotto_golden_case(case, failures, dev)
            elif scheme == "vdmpf":
                vdmpf_golden_case(case, failures, dev)
            else:
                golden_case(scheme, case, failures)
    log("golden", cases=counts, total=sum(counts.values()),
        failures=failures)
    if failures or counts != {"dpf chacha": 6, "dpf aes": 2,
                              "dcf chacha": 6, "dcf aes": 1,
                              "half_tree chacha": 4, "half_tree aes": 1,
                              "vdpf chacha": 4, "vdpf aes": 1,
                              "grotto chacha": 4, "grotto aes": 1,
                              "vdmpf chacha": 4, "vdmpf aes": 1}:
        return 1

    # 5. main paths at full size ------------------------------------------
    def point_keys(nkeys):
        """Alphas below 2^MAIN_BITS, and xs at alpha on even keys and
        elsewhere on odd ones."""
        alphas = words((nkeys,), MAIN_BITS)
        xs = alphas.clone()
        xs[1::2] ^= 1 + words((nkeys // 2,), MAIN_BITS - 1)  # != alpha
        return alphas, xs

    def point_ok(rec, betas, ea_rec, beta):
        """Every key's sum is beta at alpha (even keys) and 0 elsewhere;
        each EvalAll domain's sum is beta at alpha and 0 elsewhere."""
        want = torch.zeros_like(rec)
        want[0::2, 0] = betas[0::2, 0]
        ea_ok = True
        for n, (r, a) in ea_rec.items():
            expect = torch.zeros_like(r)
            expect[a, 0] = beta[0]
            ea_ok &= r.shape == (1 << n, 4) and torch.equal(r, expect)
        return torch.equal(rec, want), ea_ok

    def counts_of(names, sfx):
        return {k + sfx: _build.launches[k + sfx] for k in names}

    def dpf_path(prg2, sfx, log2_keys, ea_bits):
        """5a. DPF: Gen of 2^log2_keys keys, Eval of both parties, the
        reconstruction; EvalAll of one key at each of ``ea_bits``."""
        nkeys = 1 << log2_keys
        g = groups.Uint(32)
        d = Dpf(MAIN_BITS, g, prg2)
        s0s, betas = words((nkeys, 2, 4)), words((nkeys, 4))
        alphas, xs = point_keys(nkeys)
        n_ea = max(ea_bits)
        ea_seeds, ea_beta = words((2, 4)), words((4,))
        ea_alpha = int(rng.integers(0, 2**n_ea))
        torch.cuda.synchronize()

        _build.reset_launches()
        t0 = time.perf_counter()
        cws = d.gen_batch(s0s, alphas, betas)
        packed = d.gen_batch(s0s, alphas, betas, layout="packed")
        y0 = d.eval(0, s0s[:, 0].contiguous(), cws, xs)
        y1 = d.eval(1, s0s[:, 1].contiguous(), cws, xs)
        rec = g.add(g.from_block(y0), g.from_block(y1))
        ea_rec, ea_dpf, ea_key = {}, {}, {}
        for n in ea_bits:
            ea_dpf[n] = Dpf(n, g, prg2)
            ea_key[n] = ea_dpf[n].gen(ea_seeds, ea_alpha % (1 << n), ea_beta)
            e0 = ea_dpf[n].eval_all(0, ea_seeds[0], ea_key[n])
            e1 = ea_dpf[n].eval_all(1, ea_seeds[1], ea_key[n])
            ea_rec[n] = (g.add(g.from_block(e0), g.from_block(e1)),
                         ea_alpha % (1 << n))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = counts_of(DPF_SOURCES, sfx)

        rec_ok, ea_ok = point_ok(rec, betas, ea_rec, ea_beta)
        rec_ok &= torch.equal(packed.to_wire(MAIN_BITS), cws)
        sample_ok = same(cws[:SAMPLE], plain_dpf.gen(
            prg2, g, MAIN_BITS, s0s[:SAMPLE],
            blk.pack_inputs(alphas[:SAMPLE], MAIN_BITS), betas[:SAMPLE]))
        sample_ok &= same(y1[:SAMPLE], plain_dpf.eval_points(
            prg2, g, MAIN_BITS, 1, s0s[:SAMPLE, 1], cws[:SAMPLE],
            blk.pack_inputs(xs[:SAMPLE], MAIN_BITS)))
        log("main_path", scheme="dpf", prg=type(prg2).__name__, keys=nkeys,
            in_bits=MAIN_BITS, group=g.name, seconds=round(main_s, 3),
            reconstruct_ok=rec_ok, sample_vs_plain_ok=sample_ok,
            eval_all_bits=list(ea_bits), eval_all_ok=ea_ok,
            launches=launches)
        ok = (rec_ok and sample_ok and ea_ok
              and all(v > 0 for v in launches.values()))
        return ok, dict(d=d, g=g, nkeys=nkeys, s0s=s0s, alphas=alphas,
                        betas=betas, cws=cws, xs=xs, n_ea=n_ea,
                        ea_seeds=ea_seeds, ea=ea_dpf, ea_key=ea_key,
                        launches=launches, main_s=main_s)

    def dcf_path(prg4, sfx, log2_keys, ea_bits):
        """5b. DCF (lt): x below alpha on even keys, at or above it on odd
        ones; every key reconstructs to beta * (x < alpha)."""
        dkeys = 1 << log2_keys
        dg = groups.Uint(32)
        dd = Dcf(MAIN_BITS, dg, prg4, "lt")
        top = 1 << MAIN_BITS
        ds0s, dbetas = words((dkeys, 2, 4)), words((dkeys, 4))
        dalphas = words((dkeys,), MAIN_BITS).to(torch.int64)
        dalphas[0::2] |= 1  # > 0, so some x lies below
        dalphas[4] = 0
        r = words((dkeys,), MAIN_BITS).to(torch.int64)
        dxs = torch.where(torch.arange(dkeys, device=dev) % 2 == 0,
                          r % dalphas.clamp(min=1),
                          dalphas + r % (top - dalphas))
        # x = 0 below alpha; x = alpha; x = 2^n - 1; x = alpha = 0 (key 4);
        # x = alpha = 2^n - 1.
        dxs[0], dxs[1], dxs[3] = 0, dalphas[1], top - 1
        dalphas[5] = dxs[5] = top - 1
        below = dxs < dalphas
        dalphas, dxs = dalphas.to(torch.int32), dxs.to(torch.int32)
        dn_ea = max(ea_bits)
        dea_seeds, dea_beta = words((2, 4)), words((4,))
        dea_alpha = int(rng.integers(1, 2**dn_ea))
        torch.cuda.synchronize()

        _build.reset_launches()
        t0 = time.perf_counter()
        dcws = dd.gen_batch(ds0s, dalphas, dbetas)
        dy0 = dd.eval(0, ds0s[:, 0].contiguous(), dcws, dxs)
        dy1 = dd.eval(1, ds0s[:, 1].contiguous(), dcws, dxs)
        drec = dg.add(dg.from_block(dy0), dg.from_block(dy1))
        dea_rec, dea_dcf, dea_key = {}, {}, {}
        for n in ea_bits:
            a = dea_alpha % (1 << n)
            dea_dcf[n] = Dcf(n, dg, prg4, "lt")
            dea_key[n] = dea_dcf[n].gen(dea_seeds, a, dea_beta)
            e0 = dea_dcf[n].eval_all(0, dea_seeds[0], dea_key[n])
            e1 = dea_dcf[n].eval_all(1, dea_seeds[1], dea_key[n])
            dea_rec[n] = (dg.add(dg.from_block(e0), dg.from_block(e1)), a)
        torch.cuda.synchronize()
        dmain_s = time.perf_counter() - t0
        dlaunches = counts_of(DCF_SOURCES, sfx)

        want = torch.zeros_like(drec)
        want[:, 0] = torch.where(below, dbetas[:, 0], 0)
        drec_ok = torch.equal(drec, want)
        dsample_ok = same(dcws[:SAMPLE], plain_dcf.gen(
            prg4, dg, MAIN_BITS, "lt", ds0s[:SAMPLE],
            blk.pack_inputs(dalphas[:SAMPLE], MAIN_BITS), dbetas[:SAMPLE]))
        dsample_ok &= same(dy1[:SAMPLE], plain_dcf.eval_points(
            prg4, dg, MAIN_BITS, 1, ds0s[:SAMPLE, 1], dcws[:SAMPLE],
            blk.pack_inputs(dxs[:SAMPLE], MAIN_BITS)))
        dea_ok = True
        for n, (r, a) in dea_rec.items():
            expect = torch.zeros_like(r)
            expect[:a, 0] = dea_beta[0]
            dea_ok &= r.shape == (1 << n, 4) and torch.equal(r, expect)
        log("main_path", scheme="dcf", prg=type(prg4).__name__, pred="lt",
            keys=dkeys, in_bits=MAIN_BITS, group=dg.name,
            seconds=round(dmain_s, 3), reconstruct_ok=drec_ok,
            x_below_alpha=int(below.sum()), sample_vs_plain_ok=dsample_ok,
            eval_all_bits=list(ea_bits), eval_all_ok=dea_ok,
            launches=dlaunches)
        ok = (drec_ok and dsample_ok and dea_ok
              and all(v > 0 for v in dlaunches.values()))
        return ok, dict(d=dd, g=dg, nkeys=dkeys, s0s=ds0s, alphas=dalphas,
                        betas=dbetas, cws=dcws, xs=dxs, n_ea=dn_ea,
                        ea_seeds=dea_seeds, ea=dea_dcf, ea_key=dea_key,
                        launches=dlaunches, main_s=dmain_s)

    def ht_path(prg1, sfx, log2_keys, ea_bits):
        """5c. Half-Tree with the random CCR hash key: x at alpha on even
        keys, elsewhere on odd ones."""
        hkeys = 1 << log2_keys
        hg = groups.Uint(32)
        hd = HalfTreeDpf(MAIN_BITS, hg, prg1, hash_key)
        hs0s, hbetas = words((hkeys, 2, 4)), words((hkeys, 4))
        halphas, hxs = point_keys(hkeys)
        hn_ea = max(ea_bits)
        hea_seeds, hea_beta = words((2, 4)), words((4,))
        hea_alpha = int(rng.integers(0, 2**hn_ea))
        torch.cuda.synchronize()

        _build.reset_launches()
        t0 = time.perf_counter()
        hcws, hocw = hd.gen_batch(hs0s, halphas, hbetas)
        hy0 = hd.eval(0, hs0s[:, 0].contiguous(), hcws, hocw, hxs)
        hy1 = hd.eval(1, hs0s[:, 1].contiguous(), hcws, hocw, hxs)
        hrec = hg.add(hg.from_block(hy0), hg.from_block(hy1))
        hea_rec, hea_ht, hea_key = {}, {}, {}
        for n in ea_bits:
            a = hea_alpha % (1 << n)
            hea_ht[n] = HalfTreeDpf(n, hg, prg1, hash_key)
            hea_key[n] = hea_ht[n].gen(hea_seeds, a, hea_beta)
            e0 = hea_ht[n].eval_all(0, hea_seeds[0], *hea_key[n])
            e1 = hea_ht[n].eval_all(1, hea_seeds[1], *hea_key[n])
            hea_rec[n] = (hg.add(hg.from_block(e0), hg.from_block(e1)), a)
        torch.cuda.synchronize()
        hmain_s = time.perf_counter() - t0
        hlaunches = counts_of(HT_SOURCES, sfx)

        hrec_ok, hea_ok = point_ok(hrec, hbetas, hea_rec, hea_beta)
        hsample_ok = same((hcws[:SAMPLE], hocw[:SAMPLE]), plain_ht.gen(
            prg1, hg, MAIN_BITS, hk, hs0s[:SAMPLE],
            blk.pack_inputs(halphas[:SAMPLE], MAIN_BITS), hbetas[:SAMPLE]))
        hsample_ok &= same(hy1[:SAMPLE], plain_ht.eval_points(
            prg1, hg, MAIN_BITS, 1, hk, hs0s[:SAMPLE, 1], hcws[:SAMPLE],
            hocw[:SAMPLE], blk.pack_inputs(hxs[:SAMPLE], MAIN_BITS)))
        log("main_path", scheme="half_tree", prg=type(prg1).__name__,
            keys=hkeys, in_bits=MAIN_BITS, group=hg.name,
            seconds=round(hmain_s, 3), reconstruct_ok=hrec_ok,
            sample_vs_plain_ok=hsample_ok, eval_all_bits=list(ea_bits),
            eval_all_ok=hea_ok, launches=hlaunches)
        ok = (hrec_ok and hsample_ok and hea_ok
              and all(v > 0 for v in hlaunches.values()))
        return ok, dict(d=hd, g=hg, nkeys=hkeys, s0s=hs0s, alphas=halphas,
                        betas=hbetas, cws=hcws, ocw=hocw, xs=hxs, n_ea=hn_ea,
                        ea_seeds=hea_seeds, ea=hea_ht, ea_key=hea_key,
                        launches=hlaunches, main_s=hmain_s)

    def vdpf_path(prg2, sfx, name, hashes, log2_keys, ea_bits):
        """5d. VDPF keyed with ``hashes``: gen_batch from a numpy seed, x at
        alpha on even keys, elsewhere on odd ones; one key proved over
        CHAIN_ROWS points; EvalAll with the tree fold."""
        vkeys = 1 << log2_keys
        valphas, vxs = point_keys(vkeys)
        vbetas = words((vkeys, 4))
        pxs = words((CHAIN_ROWS,), MAIN_BITS)
        vea_alpha = int(rng.integers(0, 2**max(ea_bits)))
        vea_beta = words((4,))
        vd = Vdpf(MAIN_BITS, vg, prg2, hashes=hashes)
        vea_d = {n: Vdpf(n, vg, prg2, hashes=hashes) for n in ea_bits}
        kernels = (f"vdpf_eval{sfx}", f"dpf_gen{sfx}", f"dpf_eval_all{sfx}",
                   f"{name}_xor_hash", f"{name}_hash64", f"{name}_chain")
        torch.cuda.synchronize()

        _build.reset_launches()
        t0 = time.perf_counter()
        key = vd.gen_batch(np.random.default_rng(7), valphas, vbetas)
        vs0s = key[0]
        y0, p0 = vd.eval(0, vs0s[:, 0].contiguous(), *key[1:], vxs)
        y1, p1 = vd.eval(1, vs0s[:, 1].contiguous(), *key[1:], vxs)
        vrec = vg.add(vg.from_block(y0), vg.from_block(y1))
        one = [vd.eval(p, vs0s[0, p].contiguous(), key[1][0], key[2][0],
                       key[3][0], pxs)[1] for p in (0, 1)]
        proofs = [vd.prove(q, key[2][0]) for q in one]
        verified = vd.verify(*proofs)
        vea_k, vea_rec, vea_ok, peak = {}, {}, True, 0
        for n, ed in vea_d.items():
            a = vea_alpha % (1 << n)
            vea_k[n] = ed.gen_retry(np.random.default_rng(8), a, vea_beta)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            es0s, ekey = vea_k[n][0], vea_k[n][1:]
            e0, ep0 = ed.eval_all(0, es0s[0], *ekey, fold="tree")
            e1, ep1 = ed.eval_all(1, es0s[1], *ekey, fold="tree")
            vea_rec[n] = (vg.add(vg.from_block(e0), vg.from_block(e1)), a)
            vea_ok &= ed.verify(ep0, ep1)
            del e0, e1
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
        torch.cuda.synchronize()
        vmain_s = time.perf_counter() - t0
        launches = {k: _build.launches[k] for k in kernels}

        vrec_ok, ea_ok = point_ok(vrec, vbetas, vea_rec, vea_beta)
        vea_ok &= ea_ok
        pi_ok = torch.equal(p0, p1)
        sample = plain_vdpf.gen(prg2, plain_xor(hashes), vg, MAIN_BITS,
                                vs0s[:SAMPLE], blk.pack_inputs(
                                    valphas[:SAMPLE], MAIN_BITS),
                                vbetas[:SAMPLE])
        vsample_ok = same(tuple(k[:SAMPLE] for k in key[1:]), sample[:3])
        vsample_ok &= not sample[3].any()
        vsample_ok &= same((y1[:SAMPLE], p1[:SAMPLE]), plain_vdpf.eval_points(
            prg2, plain_xor(hashes), vg, MAIN_BITS, 1, vs0s[:SAMPLE, 1],
            key[1][:SAMPLE], key[2][:SAMPLE], key[3][:SAMPLE],
            blk.pack_inputs(vxs[:SAMPLE], MAIN_BITS)))
        log("main_path", scheme="vdpf", prg=type(prg2).__name__, hash=name,
            keys=vkeys, in_bits=MAIN_BITS, group=vg.name,
            seconds=round(vmain_s, 3), reconstruct_ok=vrec_ok,
            pi_tildes_equal=pi_ok, prove_points=CHAIN_ROWS,
            verify_ok=verified, sample_vs_plain_ok=vsample_ok,
            eval_all_bits=list(vea_d), eval_all_fold="tree",
            eval_all_ok=vea_ok, eval_all_peak_bytes=peak, launches=launches)
        ok = (vrec_ok and pi_ok and verified and vsample_ok and vea_ok
              and all(v > 0 for v in launches.values()))
        return ok, dict(d=vd, key=key, xs=vxs, alphas=valphas, betas=vbetas,
                        nkeys=vkeys, ea_d=vea_d, ea_k=vea_k,
                        launches=launches, main_s=vmain_s)

    # 5a-5d with ChaCha; then the AES block.
    ok, S = dpf_path(CH[2], "", MAIN_LOG2_KEYS, EVAL_ALL_BITS)
    if not ok:
        return 1
    launches = dict(S["launches"])
    ok, DS = dcf_path(CH[4], "", DCF_MAIN_LOG2_KEYS, DCF_EVAL_ALL_BITS)
    if not ok:
        return 1
    launches.update(DS["launches"])
    ok, HS = ht_path(CH[1], "", HT_MAIN_LOG2_KEYS, HT_EVAL_ALL_BITS)
    if not ok:
        return 1
    launches.update(HS["launches"])
    vmain = {}
    for name, hashes in (("blake3", Blake3(VDPF_IV)),
                         ("sha256", Sha256(VDPF_SHA_KEY))):
        ok, vmain[name] = vdpf_path(CH[2], "", name, hashes,
                                    VDPF_MAIN_LOG2_KEYS, VDPF_EVAL_ALL_BITS)
        if not ok:
            return 1
    vlaunches = {n: v["launches"] for n, v in vmain.items()}
    launches.update({k: vlaunches["blake3"][k] for k in (
        "vdpf_eval", "blake3_xor_hash", "blake3_hash64")})
    launches["sha256_xor_hash"] = vlaunches["sha256"]["sha256_xor_hash"]

    aes_main = {}
    for scheme, path, prg in (("dpf", dpf_path, AES[2]),
                              ("dcf", dcf_path, AES[4]),
                              ("half_tree", ht_path, AES[1])):
        ok, aes_main[scheme] = path(prg, "_aes", AES_LOG2_KEYS,
                                    AES_EVAL_ALL_BITS)
        if not ok:
            return 1
    ok, aes_main["vdpf"] = vdpf_path(AES[2], "_aes", "sha256",
                                     Sha256(VDPF_SHA_KEY), AES_LOG2_KEYS,
                                     AES_EVAL_ALL_BITS)
    if not ok:
        return 1
    for v in aes_main.values():  # each kernel's count from its own path
        launches.update({k: c for k, c in v["launches"].items()
                         if k.endswith("_aes") and k not in launches})

    # 5e-5f. The Grotto DCF (ChaCha, then AES) and the VDMPF (ChaCha with
    # BLAKE3 under the default IV, then SHA-256; AES with SHA-256).
    grotto_main, vdmpf_main = {}, {}
    for tag, prg2 in (("chacha", CH[2]), ("aes", AES[2])):
        ok, grotto_main[tag] = grotto_path(prg2, "_aes" if tag == "aes"
                                           else "", dev, rng)
        if not ok:
            return 1
    for tag, prg2, name, hashes in (
            ("blake3", CH[2], "blake3", Blake3(DEFAULT_HASH_IV)),
            ("sha256", CH[2], "sha256", Sha256(VDPF_SHA_KEY)),
            ("aes", AES[2], "sha256", Sha256(VDPF_SHA_KEY))):
        ok, vdmpf_main[tag] = vdmpf_path(prg2, "_aes" if tag == "aes" else "",
                                         name, hashes, dev)
        if not ok:
            return 1

    # 6. timing at the main-path shapes -----------------------------------
    def expanders(scheme, S, P):
        """EvalAll of S's largest domain through the kernels and through
        their plain versions: (kernel, plain), each the whole call,
        finalize included."""
        n = S["n_ea"]
        seed = blk.words(S["ea_seeds"][0], dev)
        if scheme == "half_tree":
            run, plain = (eval_all_cuda.ht_eval_all,
                          eval_all_cuda.ht_eval_all_plain)
            args = (P[1], S["g"], n, 0, hash_key, seed, *S["ea_key"][n])
        else:
            run, plain = ((eval_all_cuda.eval_all,
                           eval_all_cuda.eval_all_plain) if scheme == "dpf"
                          else (eval_all_cuda.dcf_eval_all,
                                eval_all_cuda.dcf_eval_all_plain))
            args = (P[2 if scheme == "dpf" else 4], S["g"], n, 0, seed,
                    blk.words(S["ea_key"][n], dev))
        return (lambda: run(*args), lambda: plain(*args))

    def tree_rows(P, tag):
        """The tree kernels at the main-path shapes of the ``tag`` paths
        ("" ChaCha, "_aes" AES): (name, source, replaces, kernel, plain,
        PRG blocks, bytes) each; a ChaCha block is CHACHA_OPS ALU ops, an
        AES one AES_ALU of them and AES_LDS shared loads."""
        D, C, H = ((S, DS, HS) if tag == "" else
                   (aes_main["dpf"], aes_main["dcf"], aes_main["half_tree"]))
        V = vmain["blake3"] if tag == "" else aes_main["vdpf"]
        ev = (D["s0s"][:, 0].contiguous(), D["cws"], D["xs"], MAIN_BITS, 0,
              P[2])
        gv = (D["s0s"], D["alphas"], MAIN_BITS, P[2], "wire")
        gkw = dict(betas=D["betas"], group=D["g"])
        cev = (C["s0s"][:, 0].contiguous(), C["cws"], C["xs"], MAIN_BITS, 0,
               P[4], "wrap")
        cgv = (C["s0s"], C["alphas"], C["betas"], MAIN_BITS, P[4], "lt",
               C["g"])
        hev = (H["s0s"][:, 0].contiguous(), H["cws"], H["xs"], MAIN_BITS, 0,
               P[1], hash_key)
        hgv = (H["s0s"], H["alphas"], MAIN_BITS, P[1], hash_key)
        hgkw = dict(betas=H["betas"], group=H["g"])
        vk = V["key"]
        vev = (vk[0][:, 0].contiguous(), vk[1], V["xs"], MAIN_BITS, 0, P[2],
               V["d"].hashes)
        nd, nc, nh, nv = D["nkeys"], C["nkeys"], H["nkeys"], V["nkeys"]
        n_ea, cn_ea, hn_ea = D["n_ea"], C["n_ea"], H["n_ea"]
        aes = tag == "_aes"
        site = {
            "dpf_eval": ("fss_tpu/ops/aes_pallas.py:313" if aes else
                         "fss_tpu/ops/dpf_pallas.py:513"),
            "dpf_gen": ("fss_tpu/ops/aes_pallas.py:1178" if aes else
                        "fss_tpu/ops/dpf_pallas.py:313"),
            "dpf_eval_all": ("XLA: fss_tpu/schemes/dpf.py:145 (AES "
                             "EvalAll)" if aes else
                             "fss_tpu/ops/eval_all_pallas.py:113"),
            "dcf_eval": ("fss_tpu/ops/aes_pallas.py:927" if aes else
                         "fss_tpu/ops/dcf_pallas.py:255"),
            "dcf_gen": ("fss_tpu/ops/aes_pallas.py:1521" if aes else
                        "fss_tpu/ops/dcf_pallas.py:531"),
            "dcf_eval_all": ("XLA: fss_tpu/schemes/dcf.py:222 (AES "
                             "EvalAll)" if aes else
                             "fss_tpu/ops/eval_all_pallas.py:262"),
            "ht_eval": ("fss_tpu/ops/aes_pallas.py:639" if aes else
                        "fss_tpu/ops/ht_pallas.py:133"),
            "ht_gen": ("XLA: fss_tpu/schemes/half_tree_dpf.py:40 (AES Gen)"
                       if aes else "fss_tpu/ops/ht_pallas.py:300"),
            "ht_eval_all": ("XLA: fss_tpu/schemes/half_tree_dpf.py:226 (AES "
                            "EvalAll)" if aes else
                            "fss_tpu/ops/eval_all_pallas.py:400"),
            "vdpf_eval": ("fss_tpu/ops/aes_pallas.py:421 (vdpf_eval_points: "
                          "B-14 chained with the XorHash)" if aes else
                          "fss_tpu/ops/vdpf_pallas.py:115"),
        }
        mul_eval = 4 if aes else 1  # DCF: AES mul=4 is 4 blocks
        dk, dp = expanders("dpf", D, P)
        ck, cp = expanders("dcf", C, P)
        hk_, hp = expanders("half_tree", H, P)
        vhash = "sha256" if aes else "blake3"
        rows = [
            # seeds 16 B, 20 B of cw a level, x 4 B in; seed 16 B, t 4 B
            # out. Two blocks a level (ChaCha: one block gives both).
            ("dpf_eval", lambda: dpf_cuda.eval_packed(*ev),
             lambda: dpf_cuda.eval_packed_plain(*ev),
             nd * MAIN_BITS * (2 if aes else 1), 0,
             nd * (16 + MAIN_BITS * 20 + 4 + 16 + 4)),
            # seeds 32 B, alpha 4 B, beta 16 B in; n + 1 rows of 32 B (the
            # output CW last), final seeds and t bits out.
            ("dpf_gen", lambda: dpf_cuda.gen_packed(*gv, **gkw),
             lambda: dpf_cuda.gen_packed_plain(*gv, **gkw),
             nd * MAIN_BITS * (4 if aes else 2), 0,
             nd * (32 + 4 + 16 + (MAIN_BITS + 1) * 32 + 2 * 16 + 2 * 4)),
            # the root 16 B, 20 B of cw a level and the output CW 16 B in;
            # a 16 B share a leaf out. 2^n - 1 expansions (the CTAs' walks
            # to their subtree roots are not work the function needs).
            ("dpf_eval_all", dk, dp, ((1 << n_ea) - 1) * (2 if aes else 1),
             0, 16 + n_ea * 20 + 16 + (1 << n_ea) * 16),
            # seeds 16 B, cw rows 32 B a level, x 4 B in; acc, seed 16 B
            # and t 4 B out.
            ("dcf_eval", lambda: dcf_cuda.eval_packed(*cev),
             lambda: dcf_cuda.eval_packed_plain(*cev),
             nc * MAIN_BITS * mul_eval, 0,
             nc * (16 + MAIN_BITS * 32 + 4 + 16 + 16 + 4)),
            # seeds 32 B, alpha 4 B, beta 16 B in; n + 1 rows of 32 B out.
            ("dcf_gen", lambda: dcf_cuda.gen_packed(*cgv),
             lambda: dcf_cuda.gen_packed_plain(*cgv),
             nc * MAIN_BITS * 2 * mul_eval, 0,
             nc * (32 + 4 + 16 + (MAIN_BITS + 1) * 32)),
            # the root 16 B, cw rows 32 B a level and the final value CW
            # 16 B in; a 16 B share a leaf out.
            ("dcf_eval_all", ck, cp, ((1 << cn_ea) - 1) * mul_eval, 0,
             16 + cn_ea * 32 + 16 + (1 << cn_ea) * 16),
            # seed 16 B, n - 1 CWs of 16 B, the last row's 20 B and x 4 B
            # in; high 16 B and low 4 B out. One block a level.
            ("ht_eval", lambda: ht_cuda.eval_packed(*hev),
             lambda: ht_cuda.eval_packed_plain(*hev), nh * MAIN_BITS, 0,
             nh * (16 + (MAIN_BITS - 1) * 16 + 20 + 4 + 16 + 4)),
            # seeds 32 B, alpha 4 B and beta 16 B in; n rows of 32 B and the
            # output CW 16 B out. Two blocks a level and four at the last.
            ("ht_gen", lambda: ht_cuda.gen_packed(*hgv, **hgkw),
             lambda: ht_cuda.gen_packed_plain(*hgv, **hgkw),
             nh * (2 * (MAIN_BITS - 1) + 4), 0,
             nh * (32 + 4 + 16 + MAIN_BITS * 32 + 16)),
            # the root 16 B, 20 B of key row a level and the output CW
            # 16 B in; a 16 B share a leaf out. 2^(n-1) - 1 doubling blocks
            # and 2^n conversion blocks (the CTAs' walks to their subtree
            # roots are not work the function needs).
            ("ht_eval_all", hk_, hp,
             (1 << (hn_ea - 1)) - 1 + (1 << hn_ea), 0,
             16 + hn_ea * 20 + 16 + (1 << hn_ea) * 16),
            # seed 16 B, 20 B of cw a level, x 4 B in; seed 16 B, t 4 B and
            # pi 64 B out. The walk's blocks and the XorHash.
            ("vdpf_eval", lambda: vdpf_cuda.eval_packed(*vev),
             lambda: vdpf_cuda.eval_packed_plain(*vev),
             nv * MAIN_BITS * (2 if aes else 1),
             nv * hash_alu(vhash, "xor_hash"),
             nv * (16 + MAIN_BITS * 20 + 4 + 16 + 4 + 64)),
        ]
        out = []
        for name, kern, plain, blocks, extra_ops, nbytes in rows:
            ops = blocks * (AES_ALU if aes else CHACHA_OPS) + extra_ops
            lds = blocks * AES_LDS if aes else 0
            out.append((name + tag, f"fss_tpu_torch/csrc/{name}.cu",
                        site[name], kern, plain, ops, nbytes, lds))
        return out

    vkeys = vmain["blake3"]["nkeys"]
    h_a = torch.zeros((vkeys, 4), dtype=torch.int32, device=dev)
    h_a[:, 0] = vmain["blake3"]["alphas"]  # Gen's H(alpha, leaf seed) rows
    h_b, h_m = words((vkeys, 4)), words((vkeys, 4, 4))
    hash_rows = [
        # a and b 16 B in, 64 B out a row; two compressions.
        ("blake3_xor_hash", "fss_tpu_torch/csrc/blake3.cu",
         "fss_tpu/ops/blake3_pallas.py:135",
         lambda: blake3_cuda.xor_hash(VDPF_IV, h_a, h_b),
         lambda: blake3_cuda.xor_hash_plain(VDPF_IV, h_a, h_b),
         vkeys * hash_alu("blake3", "xor_hash"), vkeys * (16 + 16 + 64), 0),
        # 64 B in, 32 B out a row; one compression.
        ("blake3_hash64", "fss_tpu_torch/csrc/blake3.cu",
         "fss_tpu/ops/blake3_pallas.py:171",
         lambda: blake3_cuda.hash64(VDPF_IV, h_m),
         lambda: blake3_cuda.hash64_plain(VDPF_IV, h_m),
         vkeys * hash_alu("blake3", "hash64"), vkeys * (64 + 32), 0),
        ("sha256_xor_hash", "fss_tpu_torch/csrc/sha256.cu",
         "fss_tpu/ops/sha256_pallas.py:129",
         lambda: sha256_cuda.xor_hash(VDPF_SHA_KEY, h_a, h_b),
         lambda: sha256_cuda.xor_hash_plain(VDPF_SHA_KEY, h_a, h_b),
         vkeys * hash_alu("sha256", "xor_hash"), vkeys * (16 + 16 + 64), 0),
        ("sha256_hash64", "fss_tpu_torch/csrc/sha256.cu",
         "XLA: fss_tpu/hash/sha256.py:144 (Sha256.hash64)",
         lambda: sha256_cuda.hash64(VDPF_SHA_KEY, h_m),
         lambda: sha256_cuda.hash64_plain(VDPF_SHA_KEY, h_m),
         vkeys * hash_alu("sha256", "hash64"), vkeys * (64 + 32), 0),
    ]
    # The flat proof chains on CHAIN_ROWS points (prove's shape): CHAIN_ROWS
    # H' of 64 B in, cs 64 B in, the proof 64 B out. Their bound_ms is the
    # contract's (bytes or ALU throughput); what sets their pace is one
    # step's dependency chain (the latency bound, in the timing phase).
    for name, mod, hashes in (("blake3", blake3_cuda, VDPF_IV),
                              ("sha256", sha256_cuda, VDPF_SHA_KEY)):
        hash_rows.append((
            f"{name}_chain", f"fss_tpu_torch/csrc/{name}.cu",
            "XLA: fss_tpu/schemes/vdpf.py:141 (prove, a lax.scan of H')",
            lambda m=mod, h=hashes: m.chain(h, pts, cs0),
            lambda m=mod, h=hashes: m.chain_plain(h, pts, cs0),
            CHAIN_ROWS * hash_alu(name, "hash64"),
            CHAIN_ROWS * 64 + 64 + 64, 0))
        launches[f"{name}_chain"] = vlaunches[name][f"{name}_chain"]
    launches["sha256_hash64"] = vlaunches["sha256"]["sha256_hash64"]
    rows = []
    for name, src, replaces, kern, plain, ops, nbytes, lds in (
            tree_rows(CH, "") + hash_rows + tree_rows(AES, "_aes")):
        chain = name.endswith("_chain")  # ~10 ms a call; plain ~1 s
        ms = cuda_ms(kern, 5 if chain else 20)
        plain_ms = cuda_ms(plain, 1 if chain else 2)
        err = max_abs_err(kern(), plain())
        bound_ms, bound_by = bound(ops, nbytes, lds)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "status": "ported",
                     "tpu_row": TPU_ROWS.get(name, "XLA glue"),
                     "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        if err:
            log("kernels_vs_plain", kernel=name, max_abs_err=err)
            return 1
    by_name = {r["name"]: r for r in rows}

    def launch_times(fn):
        """One call of ``fn`` after a warm-up: [kernel, ms] for each launch
        it makes, from CUDA events recorded just before and just after the
        C entry point (so an idle card waiting on the host counts too)."""
        fn()
        torch.cuda.synchronize()
        marks, launch = [], _build.launch

        def timed(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            launch(*args, **kwargs)
            ev[1].record()
            marks.append((kwargs.get("kernel") or args[0], ev))

        _build.launch = timed
        try:
            fn()
        finally:
            _build.launch = launch
        torch.cuda.synchronize()
        return [[k, ev[0].elapsed_time(ev[1])] for k, ev in marks]

    def entry_timing(scheme, P, M, extra=None):
        """End-to-end times of one path's entry points at its shapes, with
        the kernels' times beside them, and the Eval kernel's time on one
        broadcast key (the same seeds and x; every lane reads the same key
        rows, so the gap to the wire rows' time is what their loads cost),
        held against its plain version. Returns whether that held."""
        d, nk = M["d"], M["nkeys"]
        s0 = M["s0s"][:, 0].contiguous()
        if scheme == "half_tree":
            ev = lambda: d.eval(0, s0, M["cws"], M["ocw"], M["xs"])  # noqa
        else:
            ev = lambda: d.eval(0, s0, M["cws"], M["xs"])  # noqa: E731
        gen_ms = cuda_ms(lambda: d.gen_batch(M["s0s"], M["alphas"],
                                             M["betas"]), 10)
        # The DPF's packed keys: one launch too (PackedDpfKeys).
        gen_packed_ms = cuda_ms(lambda: d.gen_batch(
            M["s0s"], M["alphas"], M["betas"], layout="packed"),
                                10) if scheme == "dpf" else None
        eval_ms = M["eval_ms"] = cuda_ms(ev, 10)
        kfn, pfn, prg_args = {
            "dpf": (dpf_cuda.eval_packed, dpf_cuda.eval_packed_plain,
                    (P[2],)),
            "dcf": (dcf_cuda.eval_packed, dcf_cuda.eval_packed_plain,
                    (P[4], "wrap")),
            "half_tree": (ht_cuda.eval_packed, ht_cuda.eval_packed_plain,
                          (P[1], hash_key))}[scheme]
        bargs = (s0, M["cws"][0].contiguous(), M["xs"], MAIN_BITS, 0,
                 *prg_args)
        bcast_ok = same(kfn(*bargs), pfn(*bargs))
        bcast_ms = cuda_ms(lambda: kfn(*bargs), 20)
        eas = M["ea"]
        ea_call = {n: (lambda n=n: eas[n].eval_all(
            0, M["ea_seeds"][0], *(M["ea_key"][n] if scheme == "half_tree"
                                   else (M["ea_key"][n],)))) for n in eas}
        ea_ms = {n: cuda_ms(call, 5) for n, call in ea_call.items()}
        ea_launch_ms = {n: launch_times(call) for n, call in ea_call.items()}
        short = {"dpf": "dpf", "dcf": "dcf", "half_tree": "ht"}[scheme]
        tag = "_aes" if isinstance(P[1], AesMmo) else ""
        log("timing", scheme=scheme, prg=type(P[1]).__name__, card=kind,
            power_limit=smi.split(",")[-1].strip(),
            gen_keys_per_s=nk / (gen_ms / 1e3), gen_ms=gen_ms,
            gen_packed_ms=gen_packed_ms,
            gen_kernel_ms=by_name[f"{short}_gen{tag}"]["ms"],
            gen_bound_ms=by_name[f"{short}_gen{tag}"]["bound_ms"],
            eval_per_s=nk / (eval_ms / 1e3), eval_ms=eval_ms,
            eval_kernel_ms=by_name[f"{short}_eval{tag}"]["ms"],
            eval_broadcast_kernel_ms=bcast_ms, eval_broadcast_ok=bcast_ok,
            eval_bound_ms=by_name[f"{short}_eval{tag}"]["bound_ms"],
            eval_all_items_per_s={n: (1 << n) / (ms / 1e3)
                                  for n, ms in ea_ms.items()},
            eval_all_ms=ea_ms,
            eval_all_launches={n: len(v) for n, v in ea_launch_ms.items()},
            eval_all_launch_ms=ea_launch_ms,
            eval_all_kernel_ms=by_name[f"{short}_eval_all{tag}"]["ms"],
            main_path_s=M["main_s"], **(extra or {}),
            clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                              "temperature.gpu"))
        return bcast_ok

    for scheme, M in (("dpf", S), ("dcf", DS), ("half_tree", HS)):
        if not entry_timing(scheme, CH, M):
            return 1

    # The VDPF: the SHA-256 fused eval (held against its plain version at
    # this size too), the flat chains, the entry points, gen_batch's
    # host draws, and EvalAll's parts at 24 bits.
    vd, vkey = vmain["blake3"]["d"], vmain["blake3"]["key"]
    vsd = vmain["sha256"]["d"]
    vxs = vmain["blake3"]["xs"]
    sev = (vkey[0][:, 0].contiguous(), vkey[1], vxs, MAIN_BITS, 0, CH[2],
           vsd.hashes)
    sha_eval = (lambda: vdpf_cuda.eval_packed(*sev),
                lambda: vdpf_cuda.eval_packed_plain(*sev))
    sha_err = max_abs_err(*(f() for f in sha_eval))
    log("kernels_vs_plain", rows=vkeys,
        max_abs_err={"vdpf_eval sha256": sha_err})
    if sha_err:
        return 1
    sha_eval = (cuda_ms(sha_eval[0], 20), cuda_ms(sha_eval[1], 2),
                bound(vkeys * (MAIN_BITS * CHACHA_OPS
                               + hash_alu("sha256", "xor_hash")),
                      vkeys * (16 + MAIN_BITS * 20 + 4 + 16 + 4 + 64)))
    # The chains (their rows of the kernels line), beside the latency
    # bound that sets their pace: CHAIN_ROWS x hash_depth x
    # ALU_LATENCY_CLOCKS at the max SM clock; and their clocks a row at it.
    chain_latency = {name: CHAIN_ROWS * hash_depth(name) * ALU_LATENCY_CLOCKS
                     / (max_mhz * 1e3) for name in vmain}
    # The same bound at the measured latency: the clocks of an instruction
    # of a dependent chain of BLAKE3 G mixes (IADD3, LOP3 and SHF, what
    # both chains' paths are made of).
    alu_clocks = latencies["G"]["clocks_per_step"] / 12
    chain_latency_measured = {
        name: CHAIN_ROWS * hash_depth(name) * alu_clocks / (max_mhz * 1e3)
        for name in vmain}
    chain_rows = {name: by_name[f"{name}_chain"] for name in vmain}
    t0 = time.perf_counter()
    draws = np.random.default_rng(7).integers(0, 2**32, size=(vkeys, 2, 4))
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk.words(draws, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0

    def vdpf_times(V):
        d_, key = V["d"], V["key"]
        return (cuda_ms(lambda: d_.eval(0, key[0][:, 0].contiguous(),
                                        *key[1:], V["xs"]), 10),
                cuda_ms(lambda: d_.gen_batch(np.random.default_rng(7),
                                             V["alphas"], V["betas"]), 3),
                {n: cuda_ms(lambda e=V["ea_d"][n], k=V["ea_k"][n]: e.eval_all(
                    0, k[0][0], *k[1:], fold="tree"), 3) for n in V["ea_d"]})

    vtimes = {name: vdpf_times(v) for name, v in vmain.items()}
    vn_ea = max(VDPF_EVAL_ALL_BITS)
    vea_k = vmain["blake3"]["ea_k"]
    es, et = eval_all_cuda.expand_leaves(vd.prg, vn_ea, 0, vea_k[vn_ea][0][0],
                                         vea_k[vn_ea][1])
    ex = plain_vdpf.domain_lanes(vn_ea, dev)
    epts = blake3_cuda.xor_hash(VDPF_IV, ex, es)
    vea_parts = {
        "expand_ms": cuda_ms(lambda: eval_all_cuda.expand_leaves(
            vd.prg, vn_ea, 0, vea_k[vn_ea][0][0], vea_k[vn_ea][1]), 3),
        "pi_tilde_ms": cuda_ms(lambda: blake3_cuda.xor_hash(VDPF_IV, ex, es),
                               3),
        "tree_fold_ms": cuda_ms(lambda: vdpf_cuda.fold(
            vd.hashes, epts, vea_k[vn_ea][2], "tree"), 3),
        # The SHA-256 fold over the same 2^n rows (its cost does not depend
        # on their bytes): 2^n - 1 H' in n + 1 launches.
        "sha256_tree_fold_ms": cuda_ms(lambda: vdpf_cuda.fold(
            vsd.hashes, epts, vea_k[vn_ea][2], "tree"), 3),
        # B-12 over the same 2^n rows: the SHA-256 VDPF's pi~ there.
        "sha256_pi_tilde_ms": cuda_ms(
            lambda: sha256_cuda.xor_hash(VDPF_SHA_KEY, ex, es), 3)}
    # B-12 on rows whose points use all four lanes, beside the main
    # path's points below 2^32.
    g_a = words((vkeys, 4))
    b12 = {"points_below_2^32_ms": by_name["sha256_xor_hash"]["ms"],
           "points_of_128_bits_ms": cuda_ms(
               lambda: sha256_cuda.xor_hash(VDPF_SHA_KEY, g_a, h_b), 20)}
    if not same(sha256_cuda.xor_hash(VDPF_SHA_KEY, g_a, h_b),
                sha256_cuda.xor_hash_plain(VDPF_SHA_KEY, g_a, h_b)):
        log("kernels_vs_plain", kernel="sha256_xor_hash 128-bit points",
            max_abs_err="mismatch")
        return 1
    del g_a
    del es, et, ex, epts
    log("timing", scheme="vdpf", prg="ChaCha", card=kind,
        power_limit=smi.split(",")[-1].strip(),
        vdpf_eval_per_s={n: vkeys / (t[0] / 1e3) for n, t in vtimes.items()},
        vdpf_eval_ms={n: t[0] for n, t in vtimes.items()},
        vdpf_gen_keys_per_s={n: vkeys / (t[1] / 1e3)
                             for n, t in vtimes.items()},
        vdpf_gen_batch_ms={n: t[1] for n, t in vtimes.items()},
        gen_batch_host_draw_ms=draw_s * 1e3,
        gen_batch_stage_ms=stage_s * 1e3,
        vdpf_eval_sha256_kernel_ms=sha_eval[0],
        vdpf_eval_sha256_plain_ms=sha_eval[1],
        vdpf_eval_sha256_bound_ms=sha_eval[2],
        chain_ms={n: {"rows": CHAIN_ROWS, "ms": r["ms"],
                      "plain_ms": r["plain_ms"],
                      "clocks_per_row": r["ms"] * max_mhz * 1e3 / CHAIN_ROWS,
                      "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                      "depth": hash_depth(n),
                      "latency_bound_ms": chain_latency[n],
                      "latency_bound_share": chain_latency[n] / r["ms"],
                      "measured_alu_clocks": alu_clocks,
                      "latency_bound_measured_ms": chain_latency_measured[n],
                      "latency_bound_measured_share":
                          chain_latency_measured[n] / r["ms"]}
                  for n, r in chain_rows.items()},
        vdpf_eval_all_items_per_s={
            n: {k: (1 << k) / (ms / 1e3) for k, ms in t[2].items()}
            for n, t in vtimes.items()},
        vdpf_eval_all_ms={n: t[2] for n, t in vtimes.items()},
        vdpf_eval_all_parts={vn_ea: vea_parts},
        sha256_xor_hash=b12,
        # What B-12 feeds: the SHA-256 VDPF's Gen and its EvalAll at the
        # largest domain.
        sha256_gen_batch_ms=vtimes["sha256"][1],
        sha256_eval_all_ms={vn_ea: vtimes["sha256"][2][vn_ea]},
        clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu"))

    # The AES block's entry points.
    for scheme in ("dpf", "dcf", "half_tree"):
        if not entry_timing(scheme, AES, aes_main[scheme]):
            return 1
    av = aes_main["vdpf"]
    at = vdpf_times(av)
    log("timing", scheme="vdpf", prg="AesMmo", hash="sha256", card=kind,
        power_limit=smi.split(",")[-1].strip(),
        eval_per_s=av["nkeys"] / (at[0] / 1e3), eval_ms=at[0],
        eval_kernel_ms=by_name["vdpf_eval_aes"]["ms"],
        gen_keys_per_s=av["nkeys"] / (at[1] / 1e3), gen_batch_ms=at[1],
        eval_all_items_per_s={k: (1 << k) / (ms / 1e3)
                              for k, ms in at[2].items()},
        eval_all_ms=at[2], main_path_s=av["main_s"],
        clocks=nvidia_smi("clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu"))

    # The Grotto DCF and the VDMPF; the route kernel's row.
    power_limit = smi.split(",")[-1].strip()
    for G in grotto_main.values():
        grotto_timing(G, power_limit, kind)
    for V in vdmpf_main.values():
        vdmpf_timing(V, power_limit, kind)
    frow = feistel_row(vdmpf_main["blake3"], bound,
                       vdmpf_main["blake3"]["launches"]["feistel_route"])
    if frow["max_abs_err"]:
        log("kernels_vs_plain", kernel="feistel_route",
            max_abs_err=frow["max_abs_err"])
        return 1
    rows.append(frow)

    # 7. Multi-device runs and the front door; their launches join each
    # kernel's count (``launches_multi_device`` apart).
    ok, multi = phase7(kind, power_limit)
    if not ok:
        return 1
    for row in rows:
        row["launches_multi_device"] = multi.get(row["name"], 0)
        row["launches"] += row["launches_multi_device"]

    # 8. The sample twins, profiling and the host engine; the twins'
    # launches join each kernel's count (``launches_samples`` apart).
    ok, twins = phase8(S, dev, kind, power_limit, native_build)
    if not ok:
        return 1
    for row in rows:
        row["launches_samples"] = twins.get(row["name"], 0)
        row["launches"] += row["launches_samples"]

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
