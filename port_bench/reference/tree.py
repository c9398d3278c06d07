"""The DPF (BGI'16) and DCF (BCG+'21) of the port's wire format, in plain
PyTorch: the yardstick's own copy, written from the construction.

Blocks are [..., 4] int64 tensors of 32-bit words in [0, 2^32), word 0
the least significant. The lowest bit of word 3 is the clamped bit: a
seed's control bit t rides there. Keys are the wire rows [..., n+1, 8]:

  - DPF row i < n: s_cw with tl_cw in its clamped bit (words 0-3), tr_cw
    in word 4; row n words 0-3: the output correction word.
  - DCF row i < n: s_cw with tl_cw in its clamped bit (words 0-3), v_cw
    with tr_cw in its clamped bit (words 4-7); row n words 4-7: the last
    value correction word.

The PRG is :func:`chacha.expand`: mul = 2 for the DPF (left, right), mul
= 4 for the DCF (left seed, left value, right seed, right value). Groups:
``Group`` below, the XOR group of 16 bytes or unsigned integers of 8 to
64 bits with wrapping addition.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference import chacha

MASK = chacha.MASK


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def u64(words: torch.Tensor) -> torch.Tensor:
    """int32 words (or any int tensor) -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & MASK


def lanes(x: torch.Tensor) -> torch.Tensor:
    """Inputs given as [B] single words -> [B, 4] int64 lanes."""
    out = torch.zeros((x.shape[0], 4), dtype=torch.int64, device=x.device)
    out[:, 0] = u64(x)
    return out


def clamped(b: torch.Tensor) -> torch.Tensor:
    """The clamped bit of blocks [..., 4] as int64 0/1."""
    return b[..., 3] & 1


def cleared(b: torch.Tensor) -> torch.Tensor:
    """Blocks with the clamped bit zero."""
    return torch.cat([b[..., :3], b[..., 3:] & (MASK ^ 1)], dim=-1)


def with_bit(b: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Blocks with the clamped bit set to ``bit`` (int64 0/1)."""
    return torch.cat([b[..., :3], (b[..., 3:] & (MASK ^ 1)) | bit[..., None]],
                     dim=-1)


def pick(bit: torch.Tensor, if0: torch.Tensor, if1: torch.Tensor):
    """bit ? if1 : if0, bit of the batch's shape; blocks or bits."""
    cond = bit.bool()
    if if0.dim() > bit.dim():
        cond = cond[..., None]
    return torch.where(cond, if1, if0)


def bits_msb_first(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inputs [B, 4] (words) -> [B, n] int64 bits, the top bit first."""
    pos = torch.arange(n - 1, -1, -1, device=x.device)
    return (x[:, pos // 32] >> (pos % 32)) & 1


def split(raw: torch.Tensor):
    """A PRG output block -> (seed with the clamped bit clear, t)."""
    return cleared(raw), clamped(raw)


# ---------------------------------------------------------------------------
# Groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    """"bytes" (XOR of 16 bytes) or "uint<bits>", bits 8..64, wrapping."""

    name: str

    @property
    def bits(self) -> int:
        return 0 if self.name == "bytes" else int(self.name[4:])

    def value(self, b: torch.Tensor) -> torch.Tensor:
        """A block's group value, as a block."""
        if self.name == "bytes":
            return b
        out = torch.zeros_like(b)
        if self.bits <= 32:
            out[..., 0] = b[..., 0] & ((1 << self.bits) - 1)
        else:
            out[..., :2] = b[..., :2]
        return out

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "bytes":
            return a ^ b
        out = torch.zeros_like(a)
        if self.bits <= 32:
            out[..., 0] = (a[..., 0] + b[..., 0]) & ((1 << self.bits) - 1)
            return out
        lo = a[..., 0] + b[..., 0]
        out[..., 0] = lo & MASK
        out[..., 1] = (a[..., 1] + b[..., 1] + (lo >> 32)) & MASK
        return out

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        if self.name == "bytes":
            return a
        return self.add(torch.zeros_like(a), self._minus(a))

    def _minus(self, a: torch.Tensor) -> torch.Tensor:
        """2^bits - a, as the two's complement of the value's words."""
        out = torch.zeros_like(a)
        if self.bits <= 32:
            out[..., 0] = (-a[..., 0]) & ((1 << self.bits) - 1)
            return out
        lo = (-a[..., 0]) & MASK
        borrow = (a[..., 0] != 0).to(torch.int64)
        out[..., 0] = lo
        out[..., 1] = (-a[..., 1] - borrow) & MASK
        return out

    def sub(self, a, b):
        return self.add(a, self.neg(b))


# ---------------------------------------------------------------------------
# DPF
# ---------------------------------------------------------------------------

def dpf_gen(nonce, rounds: int, group: Group, n: int, s0s: torch.Tensor,
            alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Keys [B, n+1, 8] from seeds [B, 2, 4], alphas [B, 4] and betas
    [B, 4] (all int64 words)."""
    s = [cleared(s0s[:, 0]), cleared(s0s[:, 1])]
    B = s0s.shape[0]
    t = [torch.zeros(B, dtype=torch.int64, device=s0s.device),
         torch.ones(B, dtype=torch.int64, device=s0s.device)]
    a_bits = bits_msb_first(alphas, n)
    rows = torch.zeros((B, n + 1, 8), dtype=torch.int64, device=s0s.device)
    for i in range(n):
        a = a_bits[:, i]
        kids = []
        for p in (0, 1):
            left, right = chacha.expand(s[p], nonce, 2, rounds)
            kids.append((*split(left), *split(right)))
        (s0l, t0l, s0r, t0r), (s1l, t1l, s1r, t1r) = kids
        s_cw = pick(a, s0r ^ s1r, s0l ^ s1l)  # the sibling off alpha's path
        tl_cw = t0l ^ t1l ^ a ^ 1
        tr_cw = t0r ^ t1r ^ a
        t_cw = pick(a, tl_cw, tr_cw)
        for p, (sl, tl, sr, tr) in enumerate(kids):
            keep_s, keep_t = pick(a, sl, sr), pick(a, tl, tr)
            s[p] = keep_s ^ (s_cw * t[p][:, None])
            t[p] = keep_t ^ (t[p] & t_cw)
        rows[:, i, :4] = with_bit(s_cw, tl_cw)
        rows[:, i, 4] = tr_cw
    v = group.add(group.sub(group.value(cleared(betas)), group.value(s[0])),
                  group.value(s[1]))
    rows[:, n, :4] = pick(t[1], v, group.neg(v))
    return rows


def _dpf_row(row: torch.Tensor):
    return cleared(row[..., :4]), clamped(row[..., :4]), row[..., 4] & 1


def _dpf_children(nonce, rounds, s, t, row):
    s_cw, tl_cw, tr_cw = _dpf_row(row)
    left, right = chacha.expand(s, nonce, 2, rounds)
    (sl, tl), (sr, tr) = split(left), split(right)
    gate = t[:, None]
    return (sl ^ (s_cw * gate), tl ^ (t & tl_cw), sr ^ (s_cw * gate),
            tr ^ (t & tr_cw))


def dpf_leaf_shares(group: Group, party: int, s, t, ocw) -> torch.Tensor:
    """Shares of leaves: +-(value(s) + (t ? value(ocw) : 0))."""
    y = group.value(s)
    y = pick(t, y, group.add(y, group.value(ocw.expand_as(s))))
    return group.neg(y) if party else y


def dpf_eval_all(nonce, rounds: int, group: Group, n: int, party: int,
                 s0: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """Shares of all 2^n leaves of one key's domain, breadth first:
    [2^n, 4] int64 words."""
    s = cleared(s0)[None]
    t = torch.full((1,), party, dtype=torch.int64, device=s0.device)
    for i in range(n):
        sl, tl, sr, tr = _dpf_children(nonce, rounds, s, t, cws[i])
        s = torch.stack([sl, sr], 1).reshape(-1, 4)
        t = torch.stack([tl, tr], 1).reshape(-1)
    return dpf_leaf_shares(group, party, s, t, cws[n, :4])


# ---------------------------------------------------------------------------
# DCF
# ---------------------------------------------------------------------------

def dcf_gen(nonce, rounds: int, group: Group, n: int, pred: str,
            s0s: torch.Tensor, alphas: torch.Tensor,
            betas: torch.Tensor) -> torch.Tensor:
    """Keys [B, n+1, 8]: y0 + y1 = beta where x < alpha ("lt") or x >
    alpha ("gt"), else 0."""
    s = [cleared(s0s[:, 0]), cleared(s0s[:, 1])]
    B = s0s.shape[0]
    dev = s0s.device
    t = [torch.zeros(B, dtype=torch.int64, device=dev),
         torch.ones(B, dtype=torch.int64, device=dev)]
    a_bits = bits_msb_first(alphas, n)
    beta = group.value(cleared(betas))
    v = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    rows = torch.zeros((B, n + 1, 8), dtype=torch.int64, device=dev)
    for i in range(n):
        a = a_bits[:, i]
        kids = []
        for p in (0, 1):
            sl, vl, sr, vr = chacha.expand(s[p], nonce, 4, rounds)
            kids.append((*split(sl), *split(sr),
                         group.value(cleared(vl)), group.value(cleared(vr))))
        (s0l, t0l, s0r, t0r, v0l, v0r), (s1l, t1l, s1r, t1r, v1l, v1r) = kids
        s_cw = pick(a, s0r ^ s1r, s0l ^ s1l)
        # v_cw = -v + v1_off - v0_off (+ beta on the predicate's side),
        # "off" the direction that leaves alpha's path; negated when t1.
        v_cw = group.sub(group.sub(pick(a, v1r, v1l), v), pick(a, v0r, v0l))
        side = a if pred == "lt" else a ^ 1
        v_cw = pick(side, v_cw, group.add(v_cw, beta))
        v_cw = pick(t[1], v_cw, group.neg(v_cw))
        v = group.add(group.sub(v, pick(a, v1l, v1r)), pick(a, v0l, v0r))
        v = group.add(v, pick(t[1], v_cw, group.neg(v_cw)))
        tl_cw = t0l ^ t1l ^ a ^ 1
        tr_cw = t0r ^ t1r ^ a
        t_cw = pick(a, tl_cw, tr_cw)
        for p, (sl, tl, sr, tr, _, _) in enumerate(kids):
            keep_s, keep_t = pick(a, sl, sr), pick(a, tl, tr)
            s[p] = keep_s ^ (s_cw * t[p][:, None])
            t[p] = keep_t ^ (t[p] & t_cw)
        rows[:, i, :4] = with_bit(s_cw, tl_cw)
        rows[:, i, 4:] = with_bit(v_cw, tr_cw)
    last = group.sub(group.sub(group.value(s[1]), group.value(s[0])), v)
    rows[:, n, 4:] = pick(t[1], last, group.neg(last))
    return rows


def dcf_eval(nonce, rounds: int, group: Group, n: int, party: int,
             s0: torch.Tensor, cws: torch.Tensor,
             xs: torch.Tensor) -> torch.Tensor:
    """Shares [B, 4] of keys (s0 [B, 4], cws [B, n+1, 8]) at points xs
    [B, 4]."""
    s = cleared(s0)
    B = s.shape[0]
    t = torch.full((B,), party, dtype=torch.int64, device=s.device)
    v = torch.zeros((B, 4), dtype=torch.int64, device=s.device)
    x_bits = bits_msb_first(xs, n)
    for i in range(n):
        row = cws[:, i]
        s_cw, tl_cw = cleared(row[:, :4]), clamped(row[:, :4])
        v_cw, tr_cw = cleared(row[:, 4:]), clamped(row[:, 4:])
        sl_raw, vl, sr_raw, vr = chacha.expand(s, nonce, 4, rounds)
        (sl, tl), (sr, tr) = split(sl_raw), split(sr_raw)
        gate = t[:, None]
        sl, sr = sl ^ (s_cw * gate), sr ^ (s_cw * gate)
        tl, tr = tl ^ (t & tl_cw), tr ^ (t & tr_cw)
        bit = x_bits[:, i]
        step = group.add(group.value(cleared(pick(bit, vl, vr))),
                         group.value(v_cw * gate))
        v = group.add(v, group.neg(step) if party else step)
        s, t = pick(bit, sl, sr), pick(bit, tl, tr)
    term = group.value(s)
    term = pick(t, term, group.add(term, group.value(cws[:, n, 4:])))
    return group.add(v, group.neg(term) if party else term)
