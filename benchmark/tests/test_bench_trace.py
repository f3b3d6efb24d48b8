"""The trace's arithmetic on plain records: device time by the ranges open
at launch, the busy union, idle gaps by what the host was in."""

import pytest

from benchmark.trace import DeviceOp, Range, summarize

MS = 1_000_000  # ns


def _trace():
    ranges = [Range("window", 0, 100 * MS), Range("request", 0, 60 * MS),
              Range("tower", 5 * MS, 30 * MS), Range("siglip.mha", 10 * MS, 12 * MS),
              Range("score", 30 * MS, 60 * MS), Range("request", 61 * MS, 100 * MS),
              Range("tower", 120 * MS, 130 * MS)]  # after the window: not counted
    ops = [DeviceOp("hattn::resident_kernel<72>", 11 * MS, 21 * MS, 11 * MS),  # A in mha
           DeviceOp("nvjet_gemm", 21 * MS, 41 * MS, 20 * MS),  # tower GEMM
           DeviceOp("elementwise", 35 * MS, 45 * MS, 35 * MS),  # overlaps the GEMM
           DeviceOp("Memcpy HtoD", 50 * MS, 55 * MS, 50 * MS),
           DeviceOp("gemm_late", 95 * MS, 110 * MS, 62 * MS),  # clipped at the window
           DeviceOp("orphan", 70 * MS, 72 * MS, None)]
    return summarize(ranges, ops)


def test_window_busy_and_unlinked():
    s = _trace()
    assert s.window_s == pytest.approx(0.1)
    # busy: [11, 45] + [50, 55] + [70, 72] + [95, 100]
    assert s.busy_s == pytest.approx((34 + 5 + 2 + 5) / 1e3)
    assert s.unlinked_s == pytest.approx(0.002)
    assert s.counts == {"request": 2, "tower": 1, "siglip.mha": 1, "score": 1}


def test_device_time_by_the_ranges_open_at_launch():
    s = _trace()
    assert s.device_s("siglip.mha") == pytest.approx(0.010)
    assert s.device_s("tower") == pytest.approx(0.030)
    assert s.device_s("score") == pytest.approx(0.015)
    assert s.device_s("request") == pytest.approx(0.010 + 0.020 + 0.010 + 0.005 + 0.005)
    assert s.device_s("request", outside=("tower",)) == pytest.approx(0.020)


def test_groups_and_idle_gaps():
    s = _trace()
    groups = dict(s.device_ops)
    assert groups["kernel A flash_mha_short"] == pytest.approx(0.010)
    assert groups["library GEMMs"] == pytest.approx(0.025)
    assert groups["copies"] == pytest.approx(0.005)
    gaps = dict(s.idle_gaps)
    # [0, 11] starts in request, [45, 50] in score, [55, 70] in score then none,
    # [72, 95] in the second request
    assert gaps["host in request"] == pytest.approx(0.011 + 0.023)
    assert gaps["host in score"] == pytest.approx(0.005 + 0.015)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_one_window_is_required():
    with pytest.raises(ValueError):
        summarize([Range("request", 0, 1)], [])
