"""Two-server private information retrieval (PIR) on one card (twin of
samples/pir_tpu.py).

A client reads row ``idx`` of a database held by two non-colluding
servers, neither of which learns ``idx``:

  dealer   - one DPF key pair for the point function f(idx) = 1;
  servers  - ``Dpf.pir_answer``: EvalAll over the whole domain (the two
             launches of the ``dpf_eval_all`` kernel), then the share
             vector contracted against the database on the card (one
             ``pir_contract`` launch):
             ans_p = sum_j y_p[j] * DB[j] (mod 2^32);
  client   - ans_0 + ans_1 = DB[idx]; each server saw only a random
             share vector.

Multiplication distributes over additive shares mod 2^32, so each server
works on its own share. On a CUDA device the sample fails unless
``dpf_gen``, ``dpf_eval_all`` and ``pir_contract`` launched. Run from the
repository's root:
``PYTHONPATH=. python samples/torch_pir_gpu.py [--device cpu]``.
"""

import argparse
import json

import numpy as np
import torch

from fss_tpu_torch import _build
from fss_tpu_torch import block as blk
from fss_tpu_torch import groups
from fss_tpu_torch.api import Dpf

IN_BITS = 14
N = 1 << IN_BITS  # database rows
D = 16            # uint32 words per row (64-byte records)
KERNELS = ("dpf_gen", "dpf_eval_all", "pir_contract")


def main(device="cuda"):
    dev = torch.device(device)
    _build.reset_launches()
    rng = np.random.default_rng(3)
    db = rng.integers(0, 2**32, size=(N, D), dtype=np.uint32)
    idx = int(rng.integers(0, N))

    # Dealer: one DPF key pair, beta = 1 in word 0 of the Uint group.
    dpf = Dpf(IN_BITS, group=groups.Uint(32), device=dev)
    s0s = blk.block(rng.integers(0, 2**32, size=(2, 4)), dev)
    cws = dpf.gen(s0s, idx, blk.block([1, 0, 0, 0], dev))

    db_dev = blk.words(db, dev)

    def server(party):  # a batch of one query: [1, D] int32 shares
        return dpf.pir_answer(party, s0s[party][None], cws[None], db_dev)[0]

    ans0, ans1 = server(0), server(1)

    # Client: add the two answers; nothing else leaves a server.
    row = ((blk.u64(ans0) + blk.u64(ans1)) & blk.MASK32).cpu().numpy()
    row = row.astype(np.uint32)
    assert np.array_equal(row, db[idx]), "PIR reconstruction failed"
    if dev.type == "cuda":
        print("launches:", json.dumps(_build.launched(KERNELS)))
    print(f"PIR: row {idx} of a {N}x{D}-word database retrieved "
          f"privately ({row[:4].tolist()}...). OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
