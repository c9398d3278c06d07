#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` alone: the port's multi-device paths and
the fss_crypto front door, each checked and timed on the card.

    python3 scripts/torch_multi_device.py            # one card, as
                                                     # chip_smoke.py runs it
    python3 scripts/torch_multi_device.py --nccl 4   # 4 cards, one rank a
                                                     # card over NCCL

Builds the kernels first, then runs ``chip_smoke.phase7``: the sharded
paths over ``SHARD_RANKS`` ranks sharing one card over gloo, or over
``--nccl N`` ranks on N cards (N a power of two, at least 4 for the 2 x 2
mesh); then the 2 x 2 mesh, one rank over NCCL and the front door. Prints
``chip_smoke.py``'s ``multi_device`` and ``phase7`` lines, then the card's
name and power limit as nvidia-smi gives them. Exits non-zero without a
card, or when a path is not exact or did not launch its kernels.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nccl", type=int, default=0, metavar="N",
                    help="N ranks over NCCL, one a card (default: "
                         "SHARD_RANKS ranks over gloo on one card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_multi_device: no CUDA device", file=sys.stderr)
        return 1
    from fss_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build()
    chip_smoke.log("build", seconds=round(time.perf_counter() - t0, 3))
    smi = chip_smoke.nvidia_smi("name,power.limit")
    backend, ranks = (("nccl", args.nccl) if args.nccl
                      else ("gloo", chip_smoke.SHARD_RANKS))
    ok, _ = chip_smoke.phase7(torch.cuda.get_device_name(0),
                              smi.split(",")[-1].strip(), backend, ranks)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
