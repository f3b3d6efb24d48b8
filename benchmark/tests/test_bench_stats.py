"""Nearest-rank percentiles, the window's rate and the closed loop's window."""

import pytest

from benchmark.harness import window
from benchmark.requests import Request
from benchmark.stats import nearest_rank, window_rate


def test_nearest_rank():
    assert nearest_rank([3.0, 1.0, 2.0], 95) == 3.0
    xs = list(range(1, 21))
    assert nearest_rank(xs, 95) == 19
    assert nearest_rank(xs, 50) == 10
    assert nearest_rank([5.0], 95) == 5.0
    assert nearest_rank(list(range(1, 101)), 95) == 95
    with pytest.raises(ValueError):
        nearest_rank([], 95)


def test_window_rate_counts_the_whole_window():
    assert window_rate([512] * 4, 8.0) == 256.0
    with pytest.raises(ValueError):
        window_rate([1], 0.0)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Client:
    """Requests of 1 s each, one of them stalled for 5 s."""

    def __init__(self, clock, stall_at=2):
        self.clock, self.k, self.stall_at = clock, 0, stall_at

    def next(self):
        self.k += 1
        self.clock.t += 5.0 if self.k == self.stall_at else 1.0
        return Request(video=0, group=self.k, instruction="q", frames=512, questions=1,
                       encoded=True)


def test_the_window_ends_with_the_first_request_done_after_its_length(monkeypatch):
    import benchmark.harness as harness

    clock = _Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    done, attempted, failed, window_s = window(_Client(clock), 6.5)
    # requests end at 1, 6 (the stall), 7: the third is the first at or after 6.5
    assert [r.t_done for r in done] == [1.0, 6.0, 7.0]
    assert window_s == 7.0 and attempted == 3 and failed == 0
    # the stall stays in the rate and in the tail
    assert window_rate([r.frames for r in done], window_s) == pytest.approx(3 * 512 / 7.0)
    assert nearest_rank([r.latency_s for r in done], 95) == 5.0


def test_a_failed_request_counts_and_the_window_goes_on(monkeypatch):
    import benchmark.harness as harness

    clock = _Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)

    class Failing(_Client):
        def next(self):
            if self.k == 0:
                self.k += 1
                self.clock.t += 1.0
                raise RuntimeError("boom")
            return super().next()

    done, attempted, failed, window_s = window(Failing(clock, stall_at=-1), 2.5)
    assert failed == 1 and attempted == 3 and len(done) == 2 and window_s == 3.0
