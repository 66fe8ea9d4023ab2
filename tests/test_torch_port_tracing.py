"""The port's tracing (torchrec_tpu_torch/utils/tracing.py) on the CPU.

Untraced, a span is one shared no-op and a model part adds no autograd
node. Under `torch.profiler`, a small DLRM's train step through
`make_train_step` and a quantized DLRM's predict call record the layer
spans that the benchmark's per-layer metrics read; each `.bwd` span holds
its part's backward operators; and every concatenation, sort and matrix
product of the step and of the call sits under a span below
`## train_step ##` / `## predict ##`. A DLRM_DCN's train step records
`## dlrm_crossnet ##` and its `.bwd`, and every operator of it that moves
data sits under a layer span. The launch counters count one launch a
kernel of a step: here the plain versions stand in for the kernels, each
wrapped to count as its kernel counts on a card. The
profiler's raw events are read (name, start, end); on the CPU the backward
runs on the calling thread, so containment in time is containment.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from torchrec_tpu_torch.inference import quantize_embeddings, shard_quantized
from torchrec_tpu_torch.models import (
    DLRM,
    DLRM_DCN,
    DLRMTrain,
    SimpleDeepFMNN,
)
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops import dot_interaction as di
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils import tracing

D, DENSE_IN, B, L = 8, 5, 16, 2
ROWS = (40, 70, 25)
KEYS = [f"f{i}" for i in range(len(ROWS))]
SPAN_NODE = "_MarkBackward"  # utils/tracing.py's identity

# every span of a DLRM train step (the predict call's are PREDICT_SPANS)
STEP_SPANS = (
    "## train_step ##", "## ebc_fwd_data_parallel_g0 ##", "## ebc_output ##",
    "## lookup_route ##", "## lookup_kernel ##", "## train_dense_forward ##",
    "## dlrm_dense_arch ##", "## dlrm_interaction ##",
    "## dlrm_over_arch ##", "## train_backward ##",
    "## dlrm_dense_arch.bwd ##", "## dlrm_interaction.bwd ##",
    "## dlrm_over_arch.bwd ##", "## train_dense_optimizer ##",
    "## ebc_cotangent ##", "## ebc_update_data_parallel_g0 ##",
    "## update_row_totals ##", "## update_kernel ##")
PREDICT_SPANS = ("## predict ##", "## qebc_fwd ##", "## lookup_route ##",
                 "## lookup_kernel ##", "## ebc_output ##",
                 "## dlrm_dense_arch ##", "## dlrm_interaction ##",
                 "## dlrm_over_arch ##")
# operators that must sit under a layer span inside the step or the call
LAYER_OPS = ("aten::cat", "aten::stack", "aten::sort", "aten::mm",
             "aten::addmm", "aten::bmm")


def _tables():
    return [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                               name=f"t{i}", feature_names=[k])
            for i, (r, k) in enumerate(zip(ROWS, KEYS))]


def _dlrm(ebc, device="cpu"):
    return DLRM(ebc, DENSE_IN, (16, D), (16, 8, 1), device=device)


def _dmp(train: bool):
    ebc = EmbeddingBagCollection(_tables(), max_feature_length=L,
                                 device="meta")
    dlrm = _dlrm(ebc, "meta")
    model = DLRMTrain(dlrm) if train else dlrm
    key = ("dlrm/" if train else "") + "sparse_arch/embedding_bag_collection"
    plan = ShardingPlan({key: {f"t{i}": ParameterSharding(
        ShardingType.DATA_PARALLEL) for i in range(len(ROWS))}})
    return DistributedModelParallel(model, plan=plan, device="cpu").init(0)


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, L + 1, (len(ROWS) * B,), generator=g,
                            dtype=torch.int32)
    ids = torch.cat([
        torch.randint(0, r, (int(lengths[f * B:(f + 1) * B].sum()),),
                      generator=g, dtype=torch.int32)
        for f, r in enumerate(ROWS)])
    dense = torch.randn(B, DENSE_IN, generator=g)
    labels = torch.randint(0, 2, (B,), generator=g).float()
    return dense, KeyedJaggedTensor.from_lengths(KEYS, ids, lengths), labels


def _events(prof):
    """(name, start_ns, end_ns) of every event the profiler kept."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _spans(events, name):
    return [(s, t) for n, s, t in events if n == name]


def _inside(t, spans):
    return any(s <= t <= e for s, e in spans)


@pytest.fixture(scope="module")
def traced_step():
    """The events of one DLRM train step (after an untraced one)."""
    dmp = _dmp(train=True)
    step = dmp.make_train_step()
    step(*_batch(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*_batch(2))
    return _events(prof)


def _node_names(out: torch.Tensor):
    """The names of the autograd graph's nodes below `out`, depth first."""
    names, seen, stack = [], set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(reversed([f for f, _ in node.next_functions]))
    return names


def test_span_is_one_shared_noop_untraced():
    a, b = tracing.span("## a ##"), tracing.span("## b ##")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("## a ##"), record_function)
    assert tracing.span("## a ##") is a


def test_module_span_adds_no_node_untraced():
    """The DLRM's graph untraced has no span node, and traced it is the
    same graph with the span nodes taken out; under no_grad and
    inference_mode a traced forward adds none."""
    torch.manual_seed(3)
    model = DLRMTrain(_dlrm(EmbeddingBagCollection(
        _tables(), max_feature_length=L, device="cpu")))
    args = _batch(4)
    untraced = _node_names(model(*args)[0])
    assert SPAN_NODE not in untraced
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _node_names(model(*args)[0])
        with torch.no_grad():
            assert model(*args)[0].grad_fn is None
        with torch.inference_mode():
            assert model(*args)[0].grad_fn is None
    # three parts' outputs, the interaction's two inputs, the over arch's
    # one (the dense arch's input needs no grad)
    assert traced.count(SPAN_NODE) == 6
    assert [n for n in traced if n != SPAN_NODE] == untraced


@pytest.mark.parametrize("name", ["dlrm", "deepfm"])
def test_model_parts_record_their_backward(name):
    """Each part's forward span, and its `.bwd` span in the backward,
    with the part's backward operators inside."""
    torch.manual_seed(5)
    ebc = EmbeddingBagCollection(_tables(), max_feature_length=L,
                                 device="cpu")
    if name == "dlrm":
        model = _dlrm(ebc)
        parts = ("dlrm_dense_arch", "dlrm_interaction", "dlrm_over_arch")
    else:
        model = SimpleDeepFMNN(DENSE_IN, ebc, 16, 12, device="cpu")
        parts = ("deepfm_deep", "deepfm_fm")
    dense, kjt, _ = _batch(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(dense, kjt).sum().backward()
    events = _events(prof)
    for part in parts:
        assert len(_spans(events, f"## {part} ##")) == 1, part
        (bwd,) = _spans(events, f"## {part}.bwd ##")
        # autograd's nodes end in Backward0; the DLRM's interaction is one
        # autograd Function, whose node is DotInteractionBackward
        held = {n for n, s, _ in events
                if (n.endswith("Backward0") or n == "DotInteractionBackward")
                and _inside(s, [bwd])}
        assert held, part


def test_train_step_records_every_span(traced_step):
    names = {n for n, _, _ in traced_step if n.startswith("## ")}
    assert set(STEP_SPANS) <= names, set(STEP_SPANS) - names
    # no feature-processed EBC, so no feature processor spans
    assert not names & {"## train_feature_processor ##",
                        "## train_fp_backward ##"}


def test_interaction_bwd_holds_its_backward(traced_step):
    (bwd,) = _spans(traced_step, "## dlrm_interaction.bwd ##")
    held = {n for n, s, _ in traced_step if _inside(s, [bwd])}
    # the interaction's one Function (ops/dot_interaction.py) and, on the
    # CPU, its plain backward's S C product
    assert {"DotInteractionBackward", "aten::bmm"} <= held
    assert "AddmmBackward0" not in held
    # the over arch's linear layers' backward is under its own span
    (over,) = _spans(traced_step, "## dlrm_over_arch.bwd ##")
    assert any(n == "AddmmBackward0" and _inside(s, [over])
               for n, s, _ in traced_step)


def _loose(events, outer):
    """(the LAYER_OPS names inside the `outer` span, those of them under
    no other span)."""
    within = _spans(events, outer)
    layers = [(s, t) for n, s, t in events
              if n.startswith("## ") and n != outer]
    ops = [(n, s) for n, s, _ in events
           if n in LAYER_OPS and _inside(s, within)]
    return {n for n, _ in ops}, [(n, s) for n, s in ops
                                 if not _inside(s, layers)]


def test_train_step_ops_sit_under_a_layer_span(traced_step):
    names, loose = _loose(traced_step, "## train_step ##")
    assert names >= {"aten::cat", "aten::sort", "aten::bmm"}
    assert loose == []


def test_predict_records_its_spans_and_values():
    dmp = _dmp(train=False)
    spm = shard_quantized(quantize_embeddings(dmp, DataType.INT8,
                                              device="cpu"))
    dense, kjt, _ = _batch(7)
    untraced = spm.predict(dense, kjt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = spm.predict(dense, kjt)
    events = _events(prof)
    names = {n for n, _, _ in events if n.startswith("## ")}
    assert set(PREDICT_SPANS) <= names, set(PREDICT_SPANS) - names
    assert not any(n.endswith(".bwd ##") for n in names)
    ops, loose = _loose(events, "## predict ##")
    assert ops >= {"aten::cat", "aten::bmm", "aten::addmm"} and loose == []
    assert torch.equal(traced, untraced)


def test_counts_are_one_registry_read_by_deltas():
    before = tracing.counts()
    tracing.count("test.one")
    tracing.count("test.two", 3)
    tracing.count("test.one")
    after = tracing.counts()
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == {"test.one": 2, "test.two": 3}
    after["test.one"] = -1  # a copy: the registry is not changed
    assert tracing.counts()["test.one"] == before.get("test.one", 0) + 2


# -- DLRM_DCN -----------------------------------------------------------------

# the DCN step's spans: the DLRM's with the cross net in place of the
# interaction
DCN_SPANS = tuple(
    n.replace("dlrm_interaction", "dlrm_crossnet") for n in STEP_SPANS)
# operators that move no data: views, and a `to` or `detach` that returns
# its input
NO_WORK_OPS = {"aten::as_strided", "aten::detach", "aten::select",
               "aten::to", "aten::view", "aten::alias", "aten::slice",
               "aten::reshape", "aten::_unsafe_view", "aten::t",
               "aten::transpose", "aten::expand"}


def _dcn_dmp(optim=EmbOptimType.ADAGRAD):
    ebc = EmbeddingBagCollection(_tables(), max_feature_length=L,
                                 device="meta")
    model = DLRMTrain(DLRM_DCN(ebc, DENSE_IN, (16, D), (16, 8, 1), 2, 4,
                               device="meta"))
    return DistributedModelParallel(model, fused_optim=optim,
                                    device="cpu").init(0)


@pytest.fixture(scope="module")
def traced_dcn_step():
    """The events of one DLRM_DCN train step (after an untraced one)."""
    step = _dcn_dmp().make_train_step()
    step(*_batch(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*_batch(2))
    return _events(prof)


def test_dcn_train_step_records_its_spans(traced_dcn_step):
    names = {n for n, _, _ in traced_dcn_step if n.startswith("## ")}
    assert set(DCN_SPANS) <= names, set(DCN_SPANS) - names
    # no span that `interaction_device_ms.train` reads
    assert not any(n.startswith("## dlrm_interaction") for n in names)
    (fwd,) = _spans(traced_dcn_step, "## dlrm_crossnet ##")
    held = {n for n, s, _ in traced_dcn_step if _inside(s, [fwd])}
    assert {"aten::cat", "aten::mm", "aten::addmm", "aten::mul"} <= held
    (bwd,) = _spans(traced_dcn_step, "## dlrm_crossnet.bwd ##")
    held = {n for n, s, _ in traced_dcn_step if _inside(s, [bwd])}
    assert {"MmBackward0", "AddmmBackward0", "CatBackward0"} <= held


def test_dcn_train_step_ops_sit_under_a_layer_span(traced_dcn_step):
    """Every operator of the step that moves data sits under a span below
    `## train_step ##`: those under none are views and no-op casts."""
    within = _spans(traced_dcn_step, "## train_step ##")
    layers = [(s, t) for n, s, t in traced_dcn_step
              if n.startswith("## ") and n != "## train_step ##"]
    ops = {n for n, s, _ in traced_dcn_step
           if n.startswith("aten::") and _inside(s, within)}
    loose = {n for n, s, _ in traced_dcn_step
             if n.startswith("aten::") and _inside(s, within)
             and not _inside(s, layers)}
    assert {"aten::cat", "aten::sort", "aten::mm", "aten::index_select",
            "aten::searchsorted"} <= ops
    assert loose <= NO_WORK_OPS, loose - NO_WORK_OPS


# the kernels a step launches, by counter, and the plain version that
# stands in for each on the CPU
STAND_INS = {
    "tbe_lookup": (tl, "tbe_lookup_pooled_reference"),
    "tbe_lookup_jagged": (tl, "tbe_lookup_jagged_reference"),
    "fused_update_adagrad": (fk, "fused_update_adagrad_reference"),
    "fused_update_rowwise_adagrad": (
        fk, "fused_update_rowwise_adagrad_reference"),
    "dot_interaction": (di, "dot_interaction_reference"),
    "dot_interaction_bwd": (di, "dot_interaction_backward_reference"),
}


@pytest.fixture
def counting(monkeypatch):
    """The plain versions of STAND_INS, each counting one launch of its
    kernel a call (a plain version called inside another counts none:
    the kernel it stands in for is one launch)."""
    inside = []

    def counted(fn, name):
        def call(*args, **kwargs):
            if not inside:
                tracing.count(name)
            inside.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                inside.pop()
        return call

    for name, (mod, attr) in STAND_INS.items():
        monkeypatch.setattr(mod, attr, counted(getattr(mod, attr), name))

    def launched(step, *args):
        before = tracing.counts()
        step(*args)
        after = tracing.counts()
        return {k: after.get(k, 0) - before.get(k, 0) for k in STAND_INS}
    return launched


def test_dcn_step_launches_one_jagged_lookup(counting):
    """A DLRM_DCN step on a KeyedJaggedTensor: one K1j for its one group,
    one K6, and no K1."""
    step = _dcn_dmp().make_train_step()
    assert counting(step, *_batch(8)) == {
        "tbe_lookup": 0, "tbe_lookup_jagged": 1, "fused_update_adagrad": 1,
        "fused_update_rowwise_adagrad": 0, "dot_interaction": 0,
        "dot_interaction_bwd": 0}


def test_padded_dlrm_step_launches_as_before(counting):
    """The Criteo Kaggle DLRM's step (rowwise Adagrad, a PaddedSparseBatch
    of one id a feature, as its benchmark cells feed it): K1, K4 and the
    interaction's two kernels, once each, and no K1j; a KeyedJaggedTensor
    takes K1j in K1's place."""
    step = _dmp(train=True).make_train_step()
    dense, kjt, labels = _batch(9)
    sb = kjt.to_padded(1)
    assert isinstance(sb, PaddedSparseBatch)
    want = {"tbe_lookup": 1, "tbe_lookup_jagged": 0,
            "fused_update_adagrad": 0, "fused_update_rowwise_adagrad": 1,
            "dot_interaction": 1, "dot_interaction_bwd": 1}
    assert counting(step, dense, sb, labels) == want
    assert counting(step, dense, kjt, labels) == {
        **want, "tbe_lookup": 0, "tbe_lookup_jagged": 1}
