"""The port's fss_crypto front door (``fss_tpu_torch.crypto``) against
``fss_tpu.crypto``, on the CPU.

Every bad input of tests/test_crypto_validation.py goes through both front
doors (and both validation modules), which must raise the same exception
type with the same message. Under a pinned FSS_TPU_NONCE and
FSS_TPU_AES_KEYS both packages derive the same PRG keys, so Gen, Eval and
EvalAll are byte-equal (tolerance 0: integer crypto) for bytes and uint,
chacha and aes128_mmo, lt and gt; the port runs on the CPU by asking for
it (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from fss_tpu import crypto as jcrypto
from fss_tpu.crypto import _tensors as jtz
from fss_tpu.crypto import _validate as jval
from fss_tpu_torch import crypto as tcrypto
from fss_tpu_torch.crypto import _tensors as ttz
from fss_tpu_torch.crypto import _validate as tval
from torch_threads import one_torch_thread  # noqa: F401

NONCE = "0x1234abcd,0x0badcafe"
AES_KEYS = ",".join(bytes(range(16 * i, 16 * i + 16)).hex()
                    for i in range(4))


def _make(mod, cls, *args, **kw):
    """A front door of the JAX package (``jcrypto``) or of the port."""
    if mod is tcrypto:
        kw["device"] = "cpu"
    return getattr(mod, cls)(*args, **kw)


def _outcome(fn):
    """(exception type name, message) of ``fn()``, or None."""
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


I32 = torch.int32
S0S = torch.zeros(2, 4, dtype=I32)
S0 = torch.zeros(4, dtype=I32)
BETA = torch.zeros(4, dtype=I32)
CWS = torch.zeros(17, 8, dtype=I32)

# (name, callable of a front-door module) for each bad input of
# tests/test_crypto_validation.py that a front door can reach.
FRONT_DOOR_CASES = [
    ("in_bits 0", lambda m: _make(m, "Dpf", 0)),
    ("in_bits 129", lambda m: _make(m, "Dcf", 129)),
    ("group", lambda m: _make(m, "Dpf", 16, "invalid")),
    ("dpf prg", lambda m: _make(m, "Dpf", 16, "bytes", "invalid")),
    ("dcf prg", lambda m: _make(m, "Dcf", 16, "bytes", "invalid")),
    ("pred", lambda m: _make(m, "Dcf", 16, "bytes", "chacha", "eq")),
    ("eval party", lambda m: _make(m, "Dpf", 16).eval(2, S0, CWS, 1)),
    ("eval_all party", lambda m: _make(m, "Dcf", 16).eval_all(2, S0, CWS)),
    ("s0s shape", lambda m: _make(m, "Dpf", 16).gen(
        torch.zeros(3, 4, dtype=I32), 1, BETA)),
    ("s0s dtype", lambda m: _make(m, "Dcf", 16).gen(
        torch.zeros(2, 4), 1, BETA)),
    ("s0 shape", lambda m: _make(m, "Dpf", 16).eval(
        0, torch.zeros(2, 4, dtype=I32), CWS, 1)),
    ("s0 dtype", lambda m: _make(m, "Dcf", 16).eval_all(
        0, torch.zeros(4), CWS)),
    ("beta shape", lambda m: _make(m, "Dpf", 16).gen(
        S0S, 1, torch.zeros(3, dtype=I32))),
    ("cws shape", lambda m: _make(m, "Dpf", 16).eval(
        0, S0, torch.zeros(16, 8, dtype=I32), 1)),
    ("cws dtype", lambda m: _make(m, "Dcf", 16).eval_all(
        0, S0, torch.zeros(17, 8))),
    ("alpha negative", lambda m: _make(m, "Dpf", 20).gen(S0S, -1, BETA)),
    ("alpha too large", lambda m: _make(m, "Dcf", 20).gen(S0S, 2**20,
                                                          BETA)),
    ("x bool", lambda m: _make(m, "Dpf", 16).eval(0, S0, CWS, True)),
    ("x too large", lambda m: _make(m, "Dcf", 16).eval(0, S0, CWS, 2**16)),
    ("numpy s0s dtype", lambda m: _make(m, "Dpf", 16).gen(
        np.zeros((2, 4), np.int64), 1, BETA)),
]


@pytest.mark.parametrize("name,call", FRONT_DOOR_CASES,
                         ids=[c[0] for c in FRONT_DOOR_CASES])
def test_front_door_errors_match(name, call):
    want = _outcome(lambda: call(jcrypto))
    assert want is not None, name
    assert _outcome(lambda: call(tcrypto)) == want


# Each validation function on the inputs of tests/test_crypto_validation.py
# (valid and not): (function name, args).
VALIDATE_CASES = [
    ("validate_in_bits", (0,)), ("validate_in_bits", (64,)),
    ("validate_in_bits", (129,)), ("validate_group", ("uint",)),
    ("validate_group", ("invalid",)), ("validate_prg", ("chacha", "dpf")),
    ("validate_prg", ("aes128_mmo", "dcf")),
    ("validate_prg", ("invalid", "dpf")),
    ("validate_prg", ("chacha", "invalid")), ("validate_pred", ("gt",)),
    ("validate_pred", ("eq",)), ("validate_party", (1,)),
    ("validate_party", (2,)), ("validate_s0s", (S0S,)),
    ("validate_s0s", (np.zeros((2, 4), np.int32),)),
    ("validate_s0s", (torch.zeros(3, 4, dtype=I32),)),
    ("validate_s0s", (torch.zeros(2, 4),)),
    ("validate_s0", (torch.zeros(2, 4, dtype=I32),)),
    ("validate_s0", (torch.zeros(4),)),
    ("validate_beta", (torch.zeros(3, dtype=I32),)),
    ("validate_cws", (CWS, 16)),
    ("validate_cws", (torch.zeros(16, 8, dtype=I32), 16)),
    ("validate_cws", (torch.zeros(17, 8), 16)),
    ("validate_alpha", (2**20 - 1, 20)), ("validate_alpha", (-1, 20)),
    ("validate_alpha", (2**20, 20)),
    ("validate_domain_value", ("x", True, 20)),
    ("validate_domain_value", ("x", 2.0, 20)),
    ("validate_domain_value", ("x", 2**20, 20)),
    ("validate_device_match", (S0, torch.zeros(4, dtype=I32))),
    ("validate_cpu_only", (torch.zeros(4),)),
]


@pytest.mark.parametrize("fn,args", VALIDATE_CASES,
                         ids=[f"{c[0]}-{i}"
                              for i, c in enumerate(VALIDATE_CASES)])
def test_validation_matches(fn, args):
    """Same outcome, exception type and message byte for byte."""
    assert (_outcome(lambda: getattr(tval, fn)(*args))
            == _outcome(lambda: getattr(jval, fn)(*args)))


@pytest.fixture
def pinned(monkeypatch):
    """Pin both packages' process nonce and AES keys through the
    environment, forgetting whatever either process drew before."""
    monkeypatch.setenv("FSS_TPU_NONCE", NONCE)
    monkeypatch.setenv("FSS_TPU_AES_KEYS", AES_KEYS)
    for mod in (jtz, ttz):
        monkeypatch.setattr(mod, "_NONCE", None)
        monkeypatch.setattr(mod, "_AES_KEYS", {})


# (scheme, group, prg, pred, in_bits, whether EvalAll runs against the JAX
# package too: its EvalAll compiles for several seconds a party, so
# elsewhere the port's EvalAll is held against its Eval of every x, which
# is held against the JAX package's).
CONFIGS = [
    ("Dpf", "bytes", "chacha", None, 6, True),
    ("Dpf", "uint", "aes128_mmo", None, 7, False),
    ("Dcf", "uint", "chacha", "lt", 8, False),
    ("Dcf", "bytes", "aes128_mmo", "gt", 6, False),
]


def _u32(t):
    return np.asarray(t).view(np.uint32)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["-".join(
    str(x) for x in c[:5]) for c in CONFIGS])
def test_front_door_matches_jax(cfg, pinned):
    """Gen's cws, party 0's Eval of every x (one array) and EvalAll,
    byte-equal to ``fss_tpu.crypto``; party 1's shares reconstruct with
    party 0's to the function (so they are the JAX package's too, which
    reconstruct to it alike) and its EvalAll is its Eval of every x; a
    scalar x in numpy gives its row of the shares as a numpy array."""
    cls, group, prg, pred, n, jax_eval_all = cfg
    args = (n, group, prg) + ((pred,) if pred else ())
    jd, td = _make(jcrypto, cls, *args), _make(tcrypto, cls, *args)
    rng = np.random.default_rng(n)
    s0s = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 4),
                                        dtype=np.int32))
    beta = torch.tensor([604, 0, 0, 0], dtype=torch.int32)
    alpha = int(rng.integers(0, 1 << n))
    cws = td.gen(s0s, alpha, beta)
    assert cws.dtype == torch.int32 and cws.shape == (n + 1, 8)
    assert np.array_equal(_u32(cws), _u32(jd.gen(s0s, alpha, beta)))
    xs = np.arange(1 << n)
    ys = [_u32(td.eval(p, s0s[p], cws, xs)) for p in (0, 1)]
    assert np.array_equal(ys[0], _u32(jd.eval(0, s0s[0], cws, xs)))
    for p in (0, 1):
        one = td.eval(p, s0s[p].numpy(), cws.numpy(), alpha)
        assert isinstance(one, np.ndarray) and one.dtype == np.int32
        assert np.array_equal(_u32(one), ys[p][alpha])
        y_all = _u32(td.eval_all(p, s0s[p], cws))
        assert np.array_equal(y_all, ys[p])
    if jax_eval_all:
        assert np.array_equal(ys[0], _u32(jd.eval_all(0, s0s[0], cws)))
    hit = {"lt": xs < alpha, "gt": xs > alpha, None: xs == alpha}[pred]
    if group == "bytes":
        rec = ys[0] ^ ys[1]
        assert not rec[:, 1:].any()
    else:
        rec = ys[0] + ys[1]
    assert np.array_equal(rec[:, 0], np.where(hit, 604, 0))
