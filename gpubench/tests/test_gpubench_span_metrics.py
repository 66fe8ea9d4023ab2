"""The readers of the program's layer spans on events made by hand: each
metric's device time a call, a device operation under nested spans
counted once, `.bwd` twins matched by their forward span's prefix, and no
reading where the program opens no such span."""

from types import SimpleNamespace

import pytest

from gpubench import registry
from gpubench.trace import WINDOW_SPAN, Event, reduce

US = 1000


def _trace(spans, ops):
    """A traced window of 1 ms: `spans` (name, start us, end us) and
    `ops` (name, launch us, device start us, device end us)."""
    ev = [Event("span", WINDOW_SPAN, 0, 1000 * US)]
    ev += [Event("span", n, s * US, e * US) for n, s, e in spans]
    for i, (n, at, s, e) in enumerate(ops, 1):
        ev.append(Event("launch", "cudaLaunchKernel", at * US, at * US + 1,
                        i, i))
        ev.append(Event("device", n, s * US, e * US, i, i))
    return reduce(ev)


def _ctx(reduced, attempted=2, **kw):
    return SimpleNamespace(reduced=reduced, attempted=attempted,
                           peaks={"hbm_bytes_per_s": 1e12},
                           bytes={"quant_lookup": 15_000_000}, **kw)


def _read(name, ctx):
    return registry.module("metrics", name).read(ctx)


def _train_step():
    spans = [
        ("## train_step ##", 0, 400),
        ("## ebc_fwd_data_parallel_g0 ##", 10, 40),
        ("## lookup_route ##", 11, 20),
        ("## lookup_kernel ##", 21, 30),
        ("## ebc_output ##", 41, 45),
        ("## train_dense_forward ##", 50, 100),
        ("## dlrm_interaction ##", 60, 70),
        ("## train_backward ##", 110, 300),
        ("## dlrm_interaction.bwd ##", 150, 200),
        ("## deepfm_fm.bwd ##", 210, 220),
        ("## ebc_cotangent ##", 305, 310),
        ("## ebc_update_data_parallel_g0 ##", 311, 390),
        ("## update_row_totals ##", 312, 330),
        ("## update_kernel ##", 331, 340),
    ]
    ops = [
        ("route", 12, 500, 510),
        ("k1", 22, 510, 530),
        ("cat", 42, 530, 545),
        ("bmm", 61, 545, 565),
        ("bmm_bwd", 151, 565, 600),  # under three spans, counted once
        ("index_bwd", 160, 600, 680),
        ("fm_bwd", 211, 680, 690),
        ("stack", 306, 690, 700),
        ("sort", 313, 700, 760),
        ("k4", 332, 760, 790),
        ("loose", 395, 790, 795),  # in the update span only
    ]
    return _trace(spans, ops)


@pytest.mark.parametrize("name,ms", [
    # per step of 2: (20 + 35 + 80 + 10) us forward, .bwd and the FM's
    ("interaction_device_ms.train", (20 + 35 + 80 + 10) / 2 / 1e3),
    ("ebc_glue_device_ms.train", (15 + 10) / 2 / 1e3),
    ("update_row_totals_device_ms.train", 60 / 2 / 1e3),
    ("update_kernel_device_ms.train", 30 / 2 / 1e3),
    ("lookup_kernel_device_ms.train", 20 / 2 / 1e3),
])
def test_train_readers(name, ms):
    assert _read(name, _ctx(_train_step())) == pytest.approx(ms)


def _chunk():
    spans = [
        ("## predict ##", 0, 300),
        ("## dlrm_dense_arch ##", 5, 20),
        ("## qebc_fwd ##", 30, 100),
        ("## gpubench_quant_lookup ##", 29, 101),
        ("## lookup_route ##", 31, 60),
        ("## lookup_kernel ##", 61, 70),
        ("## dlrm_interaction ##", 110, 150),
        ("## dlrm_over_arch ##", 160, 250),
    ]
    ops = [
        ("addmm", 6, 400, 420),
        ("copy", 32, 420, 430),
        ("clamp", 40, 430, 436),
        ("kq", 62, 436, 466),
        ("permute_copy", 80, 466, 470),
        ("bmm", 111, 470, 490),
        ("gemm", 161, 490, 590),
    ]
    return _trace(spans, ops)


def test_serve_readers():
    ctx = _ctx(_chunk(), attempted=1)
    assert _read("lookup_route_device_ms.serve", ctx) == pytest.approx(
        16 / 1e3)
    assert _read("predict_dense_device_ms.serve", ctx) == pytest.approx(
        (20 + 20 + 100) / 1e3)
    # 15 MB over 1 TB/s is 15 us, over Kq's 30 us of device time
    assert _read("quant_kernel_roofline.serve", ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", [
    "interaction_device_ms.train", "ebc_glue_device_ms.train",
    "update_row_totals_device_ms.train", "update_kernel_device_ms.train",
    "lookup_kernel_device_ms.train", "lookup_route_device_ms.serve",
    "predict_dense_device_ms.serve", "quant_kernel_roofline.serve"])
def test_readers_read_nothing_without_the_spans(name):
    """A program that opens none of these spans, and an untraced run,
    give no reading."""
    bare = _trace([("## train_dense_forward ##", 0, 100)],
                  [("gemm", 10, 200, 300)])
    assert _read(name, _ctx(bare)) is None
    assert _read(name, _ctx(None)) is None
