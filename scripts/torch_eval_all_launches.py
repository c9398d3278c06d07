#!/usr/bin/env python3
"""Per-launch device times of the port's DPF and DCF EvalAll on one GPU.

    python3 scripts/torch_eval_all_launches.py [--repo DIR] [--bits 20 24]
        [--reps 5] [--out FILE]

Imports ``fss_tpu_torch`` from ``--repo`` (default: this checkout), so the
same script times another checkout of the port (an older commit unpacked
beside it) on the same card. For ``Dpf.eval_all`` (Uint(32), mul=2) and
``Dcf.eval_all`` (Uint(32), mul=4, "lt") with ChaCha and with AES-128-MMO
(the JAX bench's keys), at each domain size, it prints one JSON line:

  e2e_ms       CUDA-event time of one ``eval_all`` call, mean over reps;
  launches     kernel launches a call (``_build.launches``);
  launch_ms    each launch's time, CUDA events recorded just before and
               just after the C entry point, mean over reps;
  kernel_ms    their sum; glue_ms = e2e_ms - kernel_ms: the torch ops
               and the idle gaps between launches;
  profiler     device time by kernel name from ``torch.profiler`` over
               one call, or "no device events" when it records none.

The card's name and power limit (nvidia-smi) come first. Without a card
the script exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

AES_KEYS = tuple(bytes(range(16 * i, 16 * (i + 1))) for i in range(4))
NONCE = (0x0F0F0F0F, 0xF0F0F0F0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(
        pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--bits", type=int, nargs="+", default=[20, 24])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.repo).resolve()))
    from fss_tpu_torch import _build, groups
    from fss_tpu_torch import block as blk
    from fss_tpu_torch.api import Dcf, Dpf
    from fss_tpu_torch.prg.aes import AesMmo
    from fss_tpu_torch.prg.chacha import ChaCha

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    out = [{"repo": args.repo, "card": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": torch.__version__}]
    print(json.dumps(out[0]), flush=True)
    _build.build()

    events = []
    launch = _build.launch

    def timed_launch(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch(*a, **kw)
        end.record()
        events.append((kw.get("kernel") or a[0], start, end))

    _build.launch = timed_launch
    rng = np.random.default_rng(6)
    g = groups.Uint(32)
    prgs = {"chacha": {2: ChaCha(2, NONCE), 4: ChaCha(4, NONCE)},
            "aes": {m: AesMmo(m, AES_KEYS[:m]) for m in (2, 4)}}
    for prg_name, P in prgs.items():
        for scheme, cls, mul in (("dpf", Dpf, 2), ("dcf", Dcf, 4)):
            for n in args.bits:
                d = cls(n, g, P[mul])
                seeds = rng.integers(0, 2**32, size=(2, 4), dtype=np.uint32)
                key = d.gen(seeds, int(rng.integers(0, 2**n)),
                            rng.integers(0, 2**32, size=4, dtype=np.uint32))
                s0 = blk.words(seeds[0], torch.device("cuda"))
                key = blk.words(np.asarray(key.cpu()), torch.device("cuda"))

                def call():
                    return d.eval_all(0, s0, key)

                call()
                torch.cuda.synchronize()
                e2e, per = [], []
                for _ in range(args.reps):
                    events.clear()
                    _build.reset_launches()
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    call()
                    end.record()
                    torch.cuda.synchronize()
                    e2e.append(start.elapsed_time(end))
                    per.append([s.elapsed_time(e) for _, s, e in events])
                names = [k for k, _, _ in events]
                launch_ms = np.mean(np.array(per), axis=0).tolist()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                dev_ms = {}
                for ev in prof.key_averages():
                    t = getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0))
                    if t and ev.key not in ("cudaDeviceSynchronize",):
                        dev_ms[ev.key] = t / 1e3
                row = {"scheme": scheme, "prg": prg_name, "in_bits": n,
                       "reps": args.reps, "e2e_ms": float(np.mean(e2e)),
                       "e2e_ms_each": e2e, "launches": len(names),
                       "launch_names": sorted(set(names)),
                       "launch_ms": launch_ms,
                       "kernel_ms": float(sum(launch_ms)),
                       "glue_ms": float(np.mean(e2e) - sum(launch_ms)),
                       "profiler": dev_ms or "no device events"}
                out.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
