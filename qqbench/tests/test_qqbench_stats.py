"""The rate, window-close and percentile arithmetic."""

import statistics

import pytest

from qqbench import stats
from qqbench.stats import Call, Window


def _window(spans, sizes, verdicts=None):
    w, t = Window(), 10.0
    for i, (d, n) in enumerate(zip(spans, sizes)):
        v = True if verdicts is None else verdicts[i]
        w.calls.append(Call(start=t, end=t + d, item=i, size=n, verdict=v))
        t += d
    return w


def test_window_closes_at_the_end_of_the_first_call_past_the_length():
    w = Window()
    for d, closed in ((1.0, False), (1.5, False), (2.0, True)):
        t = w.end if w.calls else 0.0
        w.calls.append(Call(start=t, end=t + d, item=0, size=1, verdict=True))
        assert w.closed(4.0) is closed
    assert w.seconds == pytest.approx(4.5)


def test_rate_counts_every_accepted_transaction_over_the_whole_window():
    w = _window([2.0, 3.0, 5.0], [32, 32, 32], [True, False, True])
    assert stats.rate(w) == pytest.approx(64 / 10.0)   # a rejected group's time counts, not its size
    w.calls[1].verdict = None                           # nor an error's
    assert stats.rate(w) == pytest.approx(64 / 10.0)
    w.calls[2].verdict = False
    assert stats.rate(w) == pytest.approx(32 / 10.0)


def test_rate_of_an_empty_window_is_not_a_number():
    assert stats.rate(Window()) != stats.rate(Window())


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 201)), 95, 190),
    (list(range(1, 21)), 95, 19),
    ([5.0], 95, 5.0),
    ([3, 1, 2, 4], 50, 2),
    ([3, 1, 2, 4], 100, 4),
])
def test_nearest_rank_percentile(values, q, want):
    assert stats.percentile(values, q) == want


def test_spread_is_the_interquartile_range_over_the_median():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
    assert stats.spread([7.0] * 6) == 0.0
