"""The reduction of a traced window to the per-layer metrics, the device's
busy time and the breakdown, on a synthetic trace."""

import pytest

from perfbench import devtrace, harness, roofline

WALK = ("void (anonymous namespace)::tma::paged_tma_kernel<__nv_bfloat16, false, true>"
        "((anonymous namespace)::tma::Maps, (anonymous namespace)::tma::Params)")
MERGE = "void ffpa::split_merge_kernel<__nv_bfloat16>(float const*, float const*)"
COPY = "void at::native::elementwise_kernel<128, 4>(int, at::native::Loop)"


def _trace():
    # two steps of two layers: copy, walk, merge each; a gap in append and one in sync
    ops, spans, t = [], [], 0.0
    for step in range(2):
        s0 = t
        for _ in range(2):
            spans.append(("perfbench.append", t, t + 10))
            t += 10  # the device idles while the host appends
            spans.append(("perfbench.attend", t, t + 5))
            ops += [(COPY, t, t + 100), (WALK, t + 100, t + 400), (MERGE, t + 400, t + 410)]
            t += 410
        spans.append(("perfbench.restore", t, t + 1))
        spans.append(("perfbench.sync", t + 1, t + 21))
        t += 21
        spans.append(("perfbench.step", s0, t))
    return devtrace.DeviceTrace(ops=ops, spans=spans, start=0.0, end=t, steps=2)


COUNTS = dict(calls_per_step=2, flops_per_call=1e9, bytes_per_call=335e6,
              host_call_us=[100.0, 300.0, 200.0], walk_kernels=("paged_tma_kernel",),
              merge_kernels=("split_merge_kernel",))


def _read(name, counts=COUNTS):
    return harness.reader("metrics", name)(_trace(), counts)


def test_busy_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(1722e-6)
    assert tr.busy_s == pytest.approx(1640e-6)
    gaps = dict(devtrace.summarise(devtrace.idle_gaps(tr)))
    # the gap across a step boundary (sync, then the next append) is named by its middle
    assert gaps == pytest.approx({"perfbench.append": 30e-6, "perfbench.sync": 52e-6})


def test_busy_merges_overlaps_and_clips():
    ops = [("a", -5, 10), ("b", 5, 20), ("c", 30, 50), ("d", 45, 60)]
    assert devtrace.busy_intervals(ops, 0, 55) == [[0, 20], [30, 55]]


def test_roofline_share():
    least, which = roofline.bound_ms(1e9, 335e6)
    assert which == "bytes" and least == pytest.approx(0.1)
    # 310 us of walk and merge a call
    assert _read("paged_decode_roofline") == pytest.approx(100 * 0.1 / 0.31)


def test_other_host_idle_mfu():
    assert _read("paged_other.device_ms") == pytest.approx(0.1)
    assert _read("paged_host.us") == pytest.approx(200.0)
    assert _read("device.idle") == pytest.approx(100 * 82 / 1722)
    step_s = 861e-6
    assert _read("step_mfu") == pytest.approx(100 * 2e9 / (step_s * roofline.PEAK_BF16_FLOPS))


def test_readers_find_nothing():
    counts = dict(COUNTS, walk_kernels=("no_such_kernel",), host_call_us=[])
    assert _read("paged_decode_roofline", counts) is None
    assert _read("paged_host.us", counts) is None


def test_short_names():
    assert devtrace.short_name(WALK) == "tma::paged_tma_kernel<__nv_bfloat16, false, true>"
    assert devtrace.short_name(MERGE) == "ffpa::split_merge_kernel<__nv_bfloat16>"
    top = devtrace.summarise([("a", 1.0)] * 3 + [(str(i), 0.1) for i in range(20)])
    assert top[0] == ["a", 3.0] and len(top) == 10
