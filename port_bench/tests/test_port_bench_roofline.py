"""The frozen work counts come from shapes alone, as the kernel table's
arithmetic in chip_smoke.py computes them."""

import pytest

from port_bench import roofline


def test_peaks():
    assert roofline.INT_OPS_PER_S == pytest.approx(132 * 128 * 1.98e9)
    assert roofline.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("keys,n", [(1 << 20, 20), (1 << 20, 16), (37, 5)])
def test_dcf_counts(keys, n):
    assert roofline.dcf_eval(keys, n) == (keys * n * 960,
                                          keys * (16 + 32 * n + 40))
    assert roofline.dcf_gen(keys, n) == (keys * 2 * n * 960,
                                         keys * (52 + 32 * (n + 1)))


def test_dpf_eval_all_counts():
    assert roofline.dpf_eval_all(24) == ((2**24 - 1) * 960,
                                         32 + 24 * 20 + 2**24 * 16)


def test_least_seconds_names_what_sets_it():
    # The DCF Eval of the cell is bound by its ChaCha work.
    secs, by = roofline.least_seconds(*roofline.dcf_eval(1 << 20, 20))
    assert by == "operations" and 0.5e-3 < secs < 0.7e-3
    secs, by = roofline.least_seconds(0, 3.35e9)
    assert by == "bytes" and secs == pytest.approx(1e-3)
