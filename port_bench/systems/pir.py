"""A two-server PIR server through ``fss_tpu_torch.api.Dpf.pir_answer``
("answer").

The configuration gives the table (2^in_bits records of ``record_words``
32-bit words), the party that serves and the PRG (ChaCha with its nonce
and rounds, mul=2); the group is Uint(32). A mix's request is one batch of
2^batch_log2 queries, each one DPF key of beta = (1, 0, 0, 0) at a private
row, answered by the server over the whole table. The table and the
queries' inputs (seed pairs, rows) are made on the device from the seed at
set-up, the inputs as one of ``mix.pool`` sets; the keys come from the
port's Gen at set-up, as a client would send them.

The check recomputes, with the yardstick's reference, every query of every
kept request from the inputs alone: the keys by the reference's Gen, then
the answers by its EvalAll and contraction. It compares every word.
"""

from __future__ import annotations

import torch

from port_bench.reference import pir, tree

LAUNCHES = ("dpf_eval_all", "pir_contract")


def _words(g: torch.Generator, shape, device, high=None) -> torch.Tensor:
    """int32 words from ``g``: any 32 bits, or values below ``high``."""
    lo, hi = (-(1 << 31), 1 << 31) if high is None else (0, high)
    return torch.randint(lo, hi, shape, generator=g, device=device,
                         dtype=torch.int32)


class System:
    """One PIR server holding the whole table."""

    def __init__(self, cfg: dict, mix, seed: int, device):
        if mix.op != "answer":
            raise ValueError(f"the PIR system has no op {mix.op!r}")
        if cfg["group"] != pir.GROUP.name:
            raise ValueError(f"the PIR system's group is {pir.GROUP.name}")
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.party = cfg["party"]
        self.nonce = tuple(cfg["prg"]["nonce"])
        self.rounds = cfg["prg"]["rounds"]
        n, q = cfg["in_bits"], mix.batch
        self.items = q << n  # a row evaluated for each query
        self.launched = LAUNCHES
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        self.db = _words(g, (1 << n, cfg["record_words"]), self.device)
        self.inputs = [dict(s0s=_words(g, (q, 2, 4), self.device),
                            rows=_words(g, (q,), self.device, 1 << n))
                       for _ in range(mix.pool)]
        self.keys = None

    # -- the program ------------------------------------------------------

    def start(self, schedule) -> None:
        """Build the port's object, and the queries' keys, as a server
        would hold them before answering."""
        from fss_tpu_torch import api, groups
        from fss_tpu_torch.prg.chacha import ChaCha
        self.schedule = schedule
        dpf = api.Dpf(self.cfg["in_bits"], groups.Uint(32),
                      prg=ChaCha(2, self.nonce, self.rounds),
                      device=self.device)
        self.answer = dpf.pir_answer  # a port without it fails here
        betas = torch.zeros((self.mix.batch, 4), dtype=torch.int32,
                            device=self.device)
        betas[:, 0] = 1
        self.keys = [(x["s0s"][:, self.party].contiguous(),
                      dpf.gen_batch(x["s0s"], x["rows"], betas))
                     for x in self.inputs]

    def dispatch(self, i: int) -> torch.Tensor:
        s0, cws = self.keys[self.schedule.input_set(i)]
        return self.answer(self.party, s0, cws, self.db)

    def stop(self) -> None:
        """Drop the program's state (the keys); the table stays for the
        check."""
        self.keys = None
        self.answer = None

    # -- the reference ----------------------------------------------------

    def reference(self, j: int, rounds: int) -> torch.Tensor:
        """What a request on input set j returns, by the reference with a
        PRG of ``rounds`` rounds: [Q, D] int64 words."""
        x = self.inputs[j]
        n = self.cfg["in_bits"]
        s0s = tree.u64(x["s0s"])
        cws = pir.keys(self.nonce, rounds, n, s0s, tree.u64(x["rows"]))
        return pir.answers(self.nonce, rounds, n, self.party,
                           s0s[:, self.party], cws, tree.u64(self.db))

    def control_outputs(self, sets, rounds: int) -> dict:
        """The control's outputs {input set: [output]}: the reference with
        a PRG of ``rounds`` rounds in the program's place."""
        return {j: [self.reference(j, rounds)] for j in sets}

    def check(self, outputs: dict) -> tuple:
        """Compare outputs {input set: [outputs]} with the reference of the
        stated rounds, every word of every answer: ({number: (value,
        limit, what it counts)}, outputs wrong)."""
        wrong = compared = failed = 0
        for j, outs in sorted(outputs.items()):
            want = self.reference(j, self.rounds)
            for out in outs:
                got = tree.u64(out).reshape(want.shape)
                bad = (got != want).any(1)
                wrong += int(bad.sum())
                failed += int(bool(bad.any()))
                compared += want.shape[0]
        return {"answers_wrong": (wrong, 0, f"of {compared} compared")}, \
            failed
