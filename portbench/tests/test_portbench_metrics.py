"""The arithmetic of the metrics: all the work over all the time, the
tail over all blocks, the roofline counts from shapes alone, the
profiler's union of device activity."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import roofline, stats, trace
from portbench.layers import adpcm_enc_roofline_pct as k3
from portbench.layers import fir_disc_roofline_pct as k1


def test_realtime_x_is_all_work_over_all_time():
    assert stats.realtime_x(320, 3.0, 100, 10.0) == pytest.approx(9600.0)
    with pytest.raises(ValueError):
        stats.realtime_x(320, 3.0, 0, 10.0)


def test_p95_is_over_every_block():
    lat = [0.1] * 95 + [1.0] * 5
    # the tail of all 100 blocks, not a median of chunks' tails
    assert stats.p95_ms(lat) == pytest.approx(
        float(np.percentile(lat, 95)) * 1e3)
    chunks = [stats.p95_ms(lat[i:i + 20]) for i in range(0, 100, 20)]
    assert stats.p95_ms(lat) != pytest.approx(statistics.median(chunks))


def test_roofline_counts_are_functions_of_shapes():
    b, f = k1.counts(320, 144000, 143)
    assert b == 320 * 144000 * 12 + 143 * 4
    assert f == 320 * 144000 * (4 * 143 + 6)
    assert k1.counts(256, 143999, 143)[1] == 256 * 143999 * 578
    b3, f3 = k3.counts(320, 25920)
    assert (b3, f3) == (320 * 25920 * 4 + 320 * 12960, 0)
    t, by = roofline.bound_s(b, f)
    assert by == "operations" and t == pytest.approx(f / 67e12)
    assert roofline.share_pct(b, f, 2 * t) == pytest.approx(50.0)
    assert roofline.share_pct(b, f, 0.0) is None


class _Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_busy_is_the_union_and_gaps_carry_the_host_range():
    evs = [_Ev("fir_disc_kernel(x)", 0, 100, True),
           _Ev("adpcm_enc_kernel(y)", 50, 100, True),   # overlaps
           _Ev("pick_decode", 300, 100, True),          # an annotation
           _Ev("gemm", 400, 100, True),
           _Ev("pick_decode", 140, 300, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    s = trace.summarize(prof, 2, 1e-6, ranges={"pick_decode"})
    assert s.busy_s == pytest.approx(250e-9)
    assert s.kernel("fir_disc_kernel") == (pytest.approx(100e-9), 1)
    assert s.kernel("no_such_kernel") == (0, 0)
    assert s.idle_by_host == {"pick_decode": pytest.approx(250e-9)}
    assert "pick_decode" not in s.device_ops
    bd = trace.breakdown(s)
    assert len(bd["device_ops"]) <= 10 and bd["idle_gaps"][0][0] == \
        "pick_decode"


def test_roofline_readers_read_the_span_and_the_shapes():
    """A reader gives the share from the entry's shapes and the span's
    kernel time, and nothing where either is missing."""
    span = trace.Span(n_blocks=1, wall_s=1.0,
                      device_ops={"fir_disc_kernel<1>": 2e-3},
                      launches={"fir_disc_kernel<1>": 2})
    ctx = SimpleNamespace(span=span,
                          kernel_shapes={"fir_disc": (320, 144000, 143)})
    want = 100 * roofline.bound_s(*k1.counts(320, 144000, 143))[0] / 1e-3
    assert k1.read(ctx) == pytest.approx(want)
    assert k3.read(ctx) is None
    assert k1.read(SimpleNamespace(span=span, kernel_shapes={})) is None
