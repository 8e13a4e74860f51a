"""The MSM bound against counts made by hand."""

import pytest

from qqbench import roofline


def test_one_term_by_hand():
    # Straus, n = 1: width v costs 2^(v-1) - 1 + ceil(253 / v) additions of
    # 700 products and 252 doublings of 4 x 100 + 4 x 55 = 620 (156,240).
    # v = 5: 15 + 51 = 66 additions, 46,200 + 156,240 = 202,440 (v = 4:
    # 7 + 64 = 71, 205,940; v = 6: 31 + 43 = 74, 208,040).
    assert roofline.straus_products(1) == 202_440
    # Pippenger, n = 1: window c costs ceil(253 / c) x (1 + 2^c) additions
    # and (w - 1) x c doublings. c = 2: 127 x 5 = 635 additions (444,500)
    # and 252 doublings (156,240), 600,740 (c = 1: 253 x 3 = 759, 687,540;
    # c = 3: 85 x 9 = 765, 691,740).
    assert roofline.pippenger_products(1) == 600_740
    assert roofline.msm_products(1) == 202_440


def test_a_thousand_terms_by_hand():
    # Pippenger, n = 1,000, best at c = 8: w = 32, 32 x (1,000 + 256) =
    # 40,192 additions (28,134,400 products) and 31 x 8 = 248 doublings
    # (153,760): 28,288,160. (c = 7: 37 x 1,128 = 41,736 additions,
    # 29,215,200 + 252 x 620 = 29,371,440; c = 9: 29 x 1,512 = 43,848,
    # 30,693,600 + 156,240 = 30,849,840.) Straus at v = 5 needs 1,000 x
    # (15 + 51) = 66,000 additions, more.
    assert roofline.pippenger_products(1000) == 28_288_160
    assert roofline.msm_products(1000) == 28_288_160


def test_no_terms_cost_nothing():
    assert roofline.msm_products(0) == 0 and roofline.msm_bytes(0) == 0


def test_the_count_grows_with_the_terms_and_less_than_linearly_per_term():
    prev = 0
    for n in (1, 2, 16, 256, 4096, 65536):
        cur = roofline.msm_products(n)
        assert cur > prev
        prev = cur
    assert roofline.msm_products(65536) / 65536 < roofline.msm_products(256) / 256


def test_bound_on_the_h100_is_the_larger_of_operations_and_bytes():
    peaks = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert peaks["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9)
    n = 11_600
    ops_s = roofline.msm_products(n) / peaks["int32_ops_per_s"]
    bytes_s = (n * 192 + 160) / 3.35e12
    assert roofline.msm_bound_s(n, peaks) == pytest.approx(max(ops_s, bytes_s))
    assert ops_s > bytes_s
    assert roofline.peaks("some other card") is None
