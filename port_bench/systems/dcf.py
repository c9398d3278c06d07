"""Batches of DCF keys through ``fss_tpu_torch.api.Dcf``: a server's Eval
("eval") and the dealer's Gen ("gen").

The configuration gives the domain (``in_bits``), the group, the
predicate and the PRG (ChaCha with its nonce and rounds, mul=4). A mix's
request is one batch of 2^batch_log2 keys: Eval of each key at one point
by the server of party 0, or Gen of the keys. Its inputs (seed pairs,
alphas, betas, points) are one of ``mix.pool`` sets made on the device
from the seed at set-up; Eval's keys come from the port's Gen at set-up,
as a dealer would hand them to the server.

The check recomputes, with the yardstick's reference, every kept output
from the inputs alone: the keys by the reference's Gen, then the shares
by its Eval. It compares every word.
"""

from __future__ import annotations

import torch

from port_bench.reference import tree

LAUNCHES = {"eval": ("dcf_eval",), "gen": ("dcf_gen",)}
PARTY = 0  # the server that evaluates


def _words(g: torch.Generator, shape, device, high=None) -> torch.Tensor:
    """int32 words from ``g``: any 32 bits, or values below ``high``."""
    lo, hi = (-(1 << 31), 1 << 31) if high is None else (0, high)
    return torch.randint(lo, hi, shape, generator=g, device=device,
                         dtype=torch.int32)


class System:
    """One process's DCF server or dealer."""

    def __init__(self, cfg: dict, mix, seed: int, device):
        if mix.op not in LAUNCHES:
            raise ValueError(f"the DCF system has no op {mix.op!r}")
        if cfg["in_bits"] > 32:
            raise ValueError("points are single words: in_bits <= 32")
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.group = tree.Group(cfg["group"])
        self.nonce = tuple(cfg["prg"]["nonce"])
        self.rounds = cfg["prg"]["rounds"]
        self.items = mix.batch
        self.launched = LAUNCHES[mix.op]
        n, B = cfg["in_bits"], mix.batch
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        self.inputs = []
        for _ in range(mix.pool):
            self.inputs.append(dict(
                s0s=_words(g, (B, 2, 4), self.device),
                alphas=_words(g, (B,), self.device, 1 << n),
                betas=_words(g, (B, 4), self.device),
                xs=_words(g, (B,), self.device, 1 << n)))
        self.keys = None

    # -- the program ------------------------------------------------------

    def start(self, schedule) -> None:
        """Build the port's object, and Eval's keys, as a deployment
        would before serving."""
        from fss_tpu_torch import api, groups
        from fss_tpu_torch.prg.chacha import ChaCha
        bits = self.group.bits
        self.schedule = schedule
        self.dcf = api.Dcf(
            self.cfg["in_bits"],
            groups.Bytes() if bits == 0 else groups.Uint(bits),
            prg=ChaCha(4, self.nonce, self.rounds), pred=self.cfg["pred"],
            device=self.device)
        if self.mix.op == "eval":
            self.keys = [(x["s0s"][:, PARTY].contiguous(),
                          self.dcf.gen_batch(x["s0s"], x["alphas"],
                                             x["betas"]))
                         for x in self.inputs]

    def dispatch(self, i: int) -> torch.Tensor:
        j = self.schedule.input_set(i)
        x = self.inputs[j]
        if self.mix.op == "eval":
            s0, cws = self.keys[j]  # the party's seeds and keys
            return self.dcf.eval(PARTY, s0, cws, x["xs"])
        return self.dcf.gen_batch(x["s0s"], x["alphas"], x["betas"])

    def stop(self) -> None:
        """Drop the program's state (Eval's keys)."""
        self.keys = None
        self.dcf = None

    # -- the reference ----------------------------------------------------

    def reference(self, j: int, rounds: int) -> torch.Tensor:
        """What request on input set j returns, by the reference with a
        PRG of ``rounds`` rounds: int64 words."""
        x = self.inputs[j]
        n = self.cfg["in_bits"]
        keys = tree.dcf_gen(self.nonce, rounds, self.group, n,
                            self.cfg["pred"], tree.u64(x["s0s"]),
                            tree.lanes(x["alphas"]), tree.u64(x["betas"]))
        if self.mix.op == "gen":
            return keys
        return tree.dcf_eval(self.nonce, rounds, self.group, n, PARTY,
                             tree.u64(x["s0s"][:, PARTY]), keys,
                             tree.lanes(x["xs"]))

    def control_outputs(self, sets, rounds: int) -> dict:
        """The control's outputs {input set: [output]}: the reference with
        a PRG of ``rounds`` rounds in the program's place."""
        return {j: [self.reference(j, rounds)] for j in sets}

    def check(self, outputs: dict) -> tuple:
        """Compare outputs {input set: [outputs]} with the reference of the
        stated rounds: ({number: (value, limit, what it counts)}, outputs
        wrong)."""
        wrong = compared = failed = 0
        for j, outs in sorted(outputs.items()):
            want = self.reference(j, self.rounds)
            for out in outs:
                got = tree.u64(out).reshape(want.shape)
                bad = (got != want).reshape(want.shape[0], -1).any(1)
                wrong += int(bad.sum())
                failed += int(bool(bad.any()))
                compared += want.shape[0]
        name = "shares_wrong" if self.mix.op == "eval" else "keys_wrong"
        return {name: (wrong, 0, f"of {compared} compared")}, failed
