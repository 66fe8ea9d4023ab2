"""The trace reduction on events made by hand."""

import pytest

from gpubench.trace import WINDOW_SPAN, Event, reduce


def _events():
    us = 1000
    return [
        Event("span", WINDOW_SPAN, 0, 1000 * us),
        Event("span", "## ebc_fwd_data_parallel_g0 ##", 10 * us, 20 * us),
        Event("span", "## train_dense_forward ##", 30 * us, 60 * us),
        Event("span", "## deepfm_deep ##", 40 * us, 50 * us),
        Event("op", "aten::mm", 41 * us, 45 * us, 0, 7),
        # launched inside the lookup span, runs 100-200 us
        Event("launch", "cudaLaunchKernel", 12 * us, 13 * us, 1, 5),
        Event("device", "k_lookup", 100 * us, 200 * us, 1, 5),
        # launched inside the deep span (nested in the dense forward)
        Event("launch", "cudaLaunchKernel", 42 * us, 43 * us, 2, 7),
        Event("device", "k_gemm", 300 * us, 500 * us, 2, 7),
        # overlaps the gemm: busy time counts the union
        Event("launch", "cudaLaunchKernel", 55 * us, 56 * us, 3, 8),
        Event("device", "k_gemm", 450 * us, 600 * us, 3, 8),
        # runs past the window's end: clipped
        Event("launch", "cudaLaunchKernel", 70 * us, 71 * us, 4, 9),
        Event("device", "k_tail", 950 * us, 1100 * us, 4, 9),
    ]


def test_reduce_spans_busy_ops_and_gaps():
    r = reduce(_events())
    assert r.window_s == pytest.approx(1e-3)
    # 100 + (300..600) + (950..1000) us
    assert r.busy_s == pytest.approx((100 + 300 + 50) * 1e-6)
    assert r.device_s("## ebc_fwd_") == pytest.approx(100e-6)
    assert r.device_s("## train_dense_forward ##") == pytest.approx(350e-6)
    assert r.device_s("## deepfm_deep ##") == pytest.approx(200e-6)
    assert r.device_s("## ebc_fwd_", "## train_dense") == pytest.approx(
        450e-6)
    assert r.ops["k_gemm"] == pytest.approx(350e-6)
    b = r.breakdown()
    assert b["device_ops"][0][0] == "k_gemm"
    # the gap before the gemm: the host was in the deep span's aten::mm
    labels = dict(b["idle_gaps"])
    assert labels["## train_dense_forward ## aten::mm"] == pytest.approx(
        100e-6)
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        r.window_s - r.busy_s)


def test_reduce_needs_the_window():
    with pytest.raises(ValueError):
        reduce([Event("device", "k", 0, 1)])
