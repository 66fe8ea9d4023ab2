"""`crossnet_device_ms.train` on events made by hand: the device time a
step under DLRM_DCN's `## dlrm_crossnet ##` and its `.bwd`, each
operation once, and no reading where the program opens no such span (the
other cells' models, or a parent without DLRM_DCN)."""

from gpubench.tests.test_gpubench_span_metrics import _ctx, _read, _trace


def _dcn_step():
    spans = [
        ("## train_step ##", 0, 400),
        ("## train_dense_forward ##", 50, 100),
        ("## dlrm_crossnet ##", 60, 70),
        ("## dlrm_over_arch ##", 71, 80),
        ("## train_backward ##", 110, 300),
        ("## dlrm_over_arch.bwd ##", 120, 140),
        ("## dlrm_crossnet.bwd ##", 150, 200),
    ]
    ops = [
        ("cat", 61, 500, 510),
        ("gemm", 62, 510, 540),
        ("over_gemm", 72, 540, 560),
        ("over_bwd", 121, 560, 600),
        ("cross_bwd", 151, 600, 680),  # under three spans, counted once
        ("cat_bwd", 190, 680, 690),
    ]
    return _trace(spans, ops)


def test_crossnet_reader():
    # per step of 2: (10 + 30) us forward, (80 + 10) us backward
    got = _read("crossnet_device_ms.train", _ctx(_dcn_step()))
    assert abs(got - (10 + 30 + 80 + 10) / 2 / 1e3) < 1e-12


def test_crossnet_reader_reads_nothing_without_its_spans():
    dlrm = _trace([("## dlrm_interaction ##", 0, 100)],
                  [("bmm", 10, 200, 300)])
    assert _read("crossnet_device_ms.train", _ctx(dlrm)) is None
    assert _read("crossnet_device_ms.train", _ctx(None)) is None
