"""Cuckoo hashing for the VDMPF (the reference's cuckoo_hash.cuh).

Counterpart of ``fss_tpu.schemes.cuckoo``, host Python as there: insertion
is O(t * kappa) pointer chasing with data-dependent evictions
(cuckoo_hash.cuh:154-199), not hot, and sequential by nature. The eviction
choices come from a bit-exact ``std::mt19937`` seeded with 42, the
reference's ``std::mt19937 rng(42)`` (cuckoo_hash.cuh:164), so Cuckoo
tables, and with them the key layouts, are those of the reference and the
JAX package.

The batched Locate of BatchEval runs on the tensors' device
(``ops/feistel_cuda.py:route``); the host twin here serves Gen and tests.
"""

from __future__ import annotations


def _log2_series(x: float) -> float:
    """The reference's constexpr Log2 (cuckoo_hash.cuh:32-51): 40-term
    atanh series on the mantissa in [1, 2). Mirrored operation-for-
    operation (Python floats are IEEE doubles) so ch_bucket can never
    disagree with the reference by a rounding ulp that straddles an
    integer — libm log2 could."""
    e = 0
    m = x
    while m >= 2.0:
        m /= 2.0
        e += 1
    while m < 1.0:
        m *= 2.0
        e -= 1
    y = (m - 1.0) / (m + 1.0)
    y2 = y * y
    total = 0.0
    term = y
    for k in range(40):
        total += term / (2 * k + 1)
        term *= y2
    return e + 2.0 * total / 0.6931471805599453


def ch_bucket(t: int, lam: int) -> int:
    """Bucket count m from Lemma 5 / Remark 1 (cuckoo_hash.cuh:76-84).

    e = (lambda + 130 + log2(t)) / 123.5; m = ceil(e * t). Requires t >= 30.
    Uses the reference's exact constexpr Log2/Ceil arithmetic (golden-
    checked in tests/test_golden.py::test_cuckoo_ch_bucket).
    """
    assert t >= 30, "t must be >= 30 (Remark 1 of the paper)"
    e = (float(lam) + 130.0 + _log2_series(float(t))) / 123.5
    val = e * float(t)
    i = int(val)  # truncation, as the reference's Ceil does
    return i + 1 if val > float(i) else i


class Mt19937:
    """Bit-exact C++ std::mt19937 (init_genrand seeding), for the eviction
    choices in Compact. NumPy's MT19937 uses init_by_array seeding, which
    yields a different stream — hence this 20-line twin."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int):
        mt = [seed & 0xFFFFFFFF]
        for i in range(1, self.N):
            mt.append((1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i)
                      & 0xFFFFFFFF)
        self._mt = mt
        self._idx = self.N

    def __call__(self) -> int:
        if self._idx >= self.N:
            mt = self._mt
            for i in range(self.N):
                y = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
                v = mt[(i + self.M) % self.N] ^ (y >> 1)
                if y & 1:
                    v ^= self.MATRIX_A
                mt[i] = v
            self._idx = 0
        y = self._mt[self._idx]
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y


def locate_host(prp, x: int, k: int, n: int, b_size: int,
                kappa: int = 3) -> tuple:
    """(bucket, index) for hash fn k: y = PRP(x + n*k) over domain n*kappa;
    bucket = y // B, index = y % B (cuckoo_hash.cuh:114-123)."""
    y = prp.permu_host(x + n * k)
    return y // b_size, y % b_size


def compact_run(prp, alphas, m: int, n: int, b_size: int,
                ch_retry: int = 1000, kappa: int = 3):
    """Random-walk-eviction Cuckoo insertion (cuckoo_hash.cuh:154-199).

    Returns a list of m (index_into_alphas, hash_fn_k) pairs with (-1, -1)
    for empty buckets, or None on failure (caller resamples sigma).
    """
    table = [(-1, -1)] * m
    rng = Mt19937(42)
    for omega in range(len(alphas)):
        cur_idx = omega
        cur_k = rng() % kappa
        evictions = 0
        while True:
            bucket, _ = locate_host(prp, int(alphas[cur_idx]), cur_k, n,
                                    b_size, kappa)
            bucket = bucket % m
            if table[bucket][0] == -1:
                table[bucket] = (cur_idx, cur_k)
                break
            evicted = table[bucket]
            table[bucket] = (cur_idx, cur_k)
            cur_idx, cur_k = evicted[0], rng() % kappa
            evictions += 1
            if evictions > ch_retry:
                return None
    return table
