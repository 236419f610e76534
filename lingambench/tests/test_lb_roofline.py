"""The benchmark's count of the work an ordering needs."""

import pytest

from lingambench.lib import roofline

H100_SFU = roofline.sfu_rate(132, 1980e6)   # 4.18e12 special-function op/s
H100_HBM = roofline.HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("d, terms", [(100, 333_300), (487, 38_500_272),
                                      (1, 0), (2, 2), (7, 112)])
def test_pair_terms_are_the_sum_over_the_steps(d, terms):
    assert roofline.pair_terms(d) == terms
    assert terms == sum(w * (w - 1) for w in range(1, d + 1))


@pytest.mark.parametrize("shape, seconds", [
    ((1_000_000, 100, 1), 0.239),    # lingam-1m-100.fit, a fit
    ((3999, 487, 1), 0.110),         # varlingam-stocks-487.fit, a fit
    ((2048, 487, 8), 0.452),         # the stream, a slide of 8 refits
    ((3999, 487, 32), 3.53),         # the bootstrap, a call of 32
])
def test_least_times_of_the_cells(shape, seconds):
    got = roofline.ordering_least_seconds([shape], H100_SFU, H100_HBM)
    assert got == pytest.approx(seconds, abs=5e-3 * max(1.0, seconds))
    ops, nbytes = roofline.ordering_work(*shape)
    assert got == ops / H100_SFU > nbytes / H100_HBM  # bound by the SFU


def test_the_sfu_rate_is_sms_times_16_times_the_clock():
    assert H100_SFU == pytest.approx(4.18e12, rel=1e-3)
