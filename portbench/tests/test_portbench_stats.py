"""The end-to-end arithmetic on synthetic records: percentiles, the
window's edges, the token weighting of the gaps, time to first token from
the due time."""
from __future__ import annotations

import pytest

from portbench import stats


def test_percentile_is_linear_between_order_statistics():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(reversed(xs)), 0) == 1


def rec(due, deliveries):
    return {"due": due, "deliveries": deliveries}


def test_window_is_open_at_its_start_and_closed_at_its_end():
    w = (10.0, 20.0)
    assert not stats.inside(10.0, w) and stats.inside(20.0, w)
    rs = [rec(0.0, [(10.0, 5), (12.0, 3), (20.0, 2), (20.5, 7)])]
    assert stats.output_tokens(rs, w) == 5
    assert stats.tokens_per_s(rs, w) == pytest.approx(0.5)


def test_ttft_counts_from_the_due_time_inside_the_window():
    w = (10.0, 20.0)
    rs = [rec(9.0, [(10.0, 1)]),  # first token at the opening edge: out
          rec(10.5, [(11.5, 1), (12.0, 4)]),
          rec(15.0, [(19.0, 2)]),
          rec(19.0, [(21.0, 1)])]  # after the close: out
    assert sorted(stats.ttfts(rs, w)) == pytest.approx([1.0, 4.0])


def test_gaps_are_weighted_by_token():
    w = (0.0, 100.0)
    # first delivery (1 token) not a gap; then 8 tokens after 0.08 s, then
    # 1 token after 0.05 s: eight gaps of 0.01 and one of 0.05
    rs = [rec(0.0, [(1.0, 1), (1.08, 8), (1.13, 1)])]
    g = sorted(stats.itls(rs, w))
    assert g == pytest.approx([0.01] * 8 + [0.05])
    assert stats.percentile(g, 95) == pytest.approx(0.01 + 0.04 * 0.6)


def test_gaps_count_only_deliveries_inside_the_window():
    w = (1.05, 1.10)
    rs = [rec(0.0, [(1.0, 1), (1.08, 8), (1.13, 1)])]
    assert stats.itls(rs, w) == pytest.approx([0.01] * 8)


def test_a_stall_shows_in_the_tail():
    w = (0.0, 100.0)
    # 19 steady deliveries of 4 tokens 40 ms apart, then one after a
    # 200 ms admission stall
    d = [(1.0 + 0.04 * i, 4) for i in range(20)] + [(1.96, 4)]
    g = stats.itls([rec(0.0, d)], w)
    assert len(g) == 80
    assert max(g) == pytest.approx(0.05)
    # 4 of 80 gaps are the stall's: rank 0.95 x 79 = 75.05 lies just
    # below them, rank 0.99 x 79 among them
    assert stats.percentile(g, 95) == pytest.approx(0.01 + 0.04 * 0.05)
    assert stats.percentile(g, 99) == pytest.approx(0.05)
