"""The benchmark's arithmetic: window rate, percentiles, spreads, the union
of device intervals and idle gaps, the roofline counts from shapes, and the
reduction of a trace to a breakdown."""

import statistics

import numpy as np
import pytest
import torch

from slambench.lib import roofline, stats, trace


def test_rate_is_all_work_over_all_time():
    assert stats.rate(30, 40.0) == 0.75
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).gamma(2.0, 300.0, size=37)
    assert stats.percentile(list(xs), q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.5, 12.0, 10.2]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]) == 4.0
    assert stats.union_length([]) == 0.0


def test_gaps_are_what_no_interval_covers():
    assert stats.gaps([(1, 2), (1.5, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]
    assert stats.gaps([(-1, 11)], 0, 10) == []


def test_hamming_work_counts_inputs_outputs_and_operations():
    b, ops = roofline.hamming_work(4096, 1000, alt=False)
    assert b == (4096 + 1000) * 32 + 4096 * 1000 * 4
    assert ops == 4096 * 1000 * 24
    b2, ops2 = roofline.hamming_work(4096, 1000, alt=True)
    assert b2 == b + 4096 * 32 and ops2 == 4096 * 1000 * 49
    # bytes bound it on the card: 16.5 MB over 3.35 TB/s
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(b, ops, kind) == pytest.approx(b / 3.35e12)


def test_sampler_work_counts_distinct_pixels_once():
    imgs_shape = (2, 8, 8, 3)
    group_k = torch.tensor([0, 1])
    # group 0: two samples in one cell share its four pixels; group 1: one
    # sample on the last column, whose right neighbours lie off the image
    uv = torch.tensor([[[1.2, 1.3], [1.7, 1.9]], [[7.0, 2.5], [3.0, 3.0]]])
    mask = torch.tensor([[True, True], [True, False]])
    n_bytes, ops = roofline.sampler_work(imgs_shape, group_k, uv, mask)
    n_pix = 4 + 2
    assert n_bytes == 4 * (8 + 1 + 12) + 2 * 8 + n_pix * 12
    assert ops == 4 * 3 * 12


def test_peaks_refuse_an_unknown_card():
    with pytest.raises(KeyError):
        roofline.peaks("some other card")


class _Ev:
    def __init__(self, name, s, e, dev):
        self.name, self.device_type = name, dev
        self.time_range = type("R", (), {"start": s, "end": e})()


class _Prof:
    def __init__(self, evs):
        self._evs = evs

    def events(self):
        return self._evs


def test_trace_reduction_busy_share_and_idle_by_span():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    prof = _Prof([
        _Ev(trace.WINDOW_RANGE, 0, 100, cpu), _Ev(trace.WINDOW_RANGE, 0, 100, cuda),
        _Ev("span:tracking.process", 10, 90, cpu),
        _Ev("span:ops.hamming_matrix", 20, 30, cpu),
        # the ranges' annotations on the device's timeline: not operations
        _Ev("span:tracking.process", 40, 100, cuda),
        _Ev("span:ops.hamming_matrix", 40, 60, cuda),
        _Ev("k1", 0, 10, cuda), _Ev("k2", 5, 15, cuda),   # overlap counted once
        _Ev("k1", 40, 60, cuda), _Ev("memcpy", 95, 100, cuda),
    ])
    red = trace.reduce(prof)
    assert trace.busy_us(red) == 15 + 20 + 5
    assert red["ranges"] == {"tracking.process": 25.0, "ops.hamming_matrix": 20.0}
    br = trace.breakdown(red)
    assert br["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    idle = dict(br["idle_gaps"])
    # gaps: 15-40 (mid 27.5, inside the Hamming span), 60-95 (mid 77.5, inside process)
    assert idle == {"ops.hamming_matrix": pytest.approx(25e-6),
                    "tracking.process": pytest.approx(35e-6)}


def test_trace_without_window_range_raises():
    with pytest.raises(RuntimeError):
        trace.reduce(_Prof([]))
