"""Two-server DPF PIR (Boyle-Gilboa-Ishai, CCS 2016) in plain PyTorch: the
yardstick's own copy, from the frozen DPF of :mod:`tree`.

A query for row idx is one DPF key pair of beta = (1, 0, 0, 0) at idx over
Uint(32). Server p expands its key over the whole domain; word 0 of its
shares is its selector vector y_p, and its answer is

    ans_p = sum_j y_p[j] * db[j]  (mod 2^32),

so that ans_0 + ans_1 = db[idx] mod 2^32. Words are int64 values in [0,
2^32), as in :mod:`tree`.
"""

from __future__ import annotations

import torch

from port_bench.reference import tree

GROUP = tree.Group("uint32")

# A block's products of a selector word and a 16-bit half of a table word
# are below 2^48: sums of at most 2^14 of them stay below 2^62.
BLOCK_ROWS = 1 << 14
BLOCK_VALUES = 1 << 24  # products a block holds at most
WALK_LEAVES = 1 << 24  # leaves of the keys expanded together, at most


def betas(queries: int, device) -> torch.Tensor:
    """The queries' betas: (1, 0, 0, 0) each, [Q, 4] int64."""
    out = torch.zeros((queries, 4), dtype=torch.int64, device=device)
    out[:, 0] = 1
    return out


def keys(nonce, rounds: int, n: int, s0s: torch.Tensor,
         rows: torch.Tensor) -> torch.Tensor:
    """The queries' keys [Q, n+1, 8] from seeds [Q, 2, 4] and the private
    rows [Q] (int64 words)."""
    return tree.dpf_gen(nonce, rounds, GROUP, n, s0s, tree.lanes(rows),
                        betas(s0s.shape[0], s0s.device))


def contract(ys: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """sum_j ys[q, j] * db[j] mod 2^32: ys [Q, N] and db [N, D] words in
    [0, 2^32) -> [Q, D] int64, in int64 blocks of rows, each table word
    split into 16-bit halves."""
    queries, cols = ys.shape[0], db.shape[1]
    step = max(1, min(BLOCK_ROWS, BLOCK_VALUES // (queries * cols)))
    out = torch.zeros((queries, cols), dtype=torch.int64, device=ys.device)
    for j in range(0, db.shape[0], step):
        x = db[j:j + step]
        y = ys[:, j:j + step, None]
        lo = (y * (x & 0xFFFF)).sum(1)
        hi = (y * (x >> 16)).sum(1) & 0xFFFF  # its low half, shifted
        out = (out + lo + (hi << 16)) & tree.MASK
    return out


def selectors(nonce, rounds: int, n: int, party: int, s0s: torch.Tensor,
              cws: torch.Tensor) -> torch.Tensor:
    """Word 0 of server ``party``'s shares of every leaf of each key: [Q,
    2^n]. :func:`tree.dpf_eval_all`'s walk, breadth first, for several
    keys at once (each node beside its key's correction word row), at most
    ``WALK_LEAVES`` leaves together."""
    per = max(1, WALK_LEAVES >> n)
    out = []
    for k in range(0, s0s.shape[0], per):
        keys = cws[k:k + per]
        s = tree.cleared(s0s[k:k + per])
        t = torch.full((s.shape[0],), party, dtype=torch.int64,
                       device=s.device)
        for i in range(n):
            rows = keys[:, i].repeat_interleave(1 << i, dim=0)
            sl, tl, sr, tr = tree._dpf_children(nonce, rounds, s, t, rows)
            s = torch.stack([sl, sr], 1).reshape(-1, 4)
            t = torch.stack([tl, tr], 1).reshape(-1)
        ocw = keys[:, n, :4].repeat_interleave(1 << n, dim=0)
        y = tree.dpf_leaf_shares(GROUP, party, s, t, ocw)[:, 0]
        out.append(y.reshape(-1, 1 << n))
    return torch.cat(out)


def answers(nonce, rounds: int, n: int, party: int, s0s: torch.Tensor,
            cws: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Server ``party``'s answers [Q, D] (int64 words) to the queries of
    keys cws [Q, n+1, 8] from its seeds s0s [Q, 4], over db [2^n, D]: the
    keys' full-domain evaluations, then the contraction."""
    return contract(selectors(nonce, rounds, n, party, s0s, cws), db)
