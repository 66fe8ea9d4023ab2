"""The reference against the port at a tiny size on the CPU, through the
drivers' whole runs: a sound run comes out correct under the cells'
limits; the control (the reference in the next lower precision in the
program's place) and each fault the cell can have, planted under the
timed path, come out not correct."""

import dataclasses

import pytest
import torch

from gpubench import check, registry
from gpubench.tests.conftest import SCORE_CELLS, TRAIN_CELLS, tiny_run


def _correct(workload, res) -> bool:
    ok, _ = check.judge(res.numbers, registry.data("limits", workload))
    return ok and res.failed == 0


def _driver(r):
    return registry.module("drivers", r.traffic["driver"])


def _half_batch(step, dmp):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch

    def f(dense, sb, labels):
        if isinstance(sb, KeyedJaggedTensor):  # a program's own form
            sb = sb.to_padded(int(sb.lengths.max()))
        n = dense.shape[0] // 2
        half = PaddedSparseBatch(ids=sb.ids[:, :n], lengths=sb.lengths[:, :n],
                                 keys=sb.keys)
        return step(dense[:n], half, labels[:n])
    return f


def _altered_loss(step, dmp):
    calls = []

    def f(*args):
        loss, aux = step(*args)
        calls.append(1)
        return (loss * 1.01 if len(calls) == 1 else loss), aux
    return f


TRAIN_FAULTS = {
    # the step returns the state unchanged: the loss, no update
    "unchanged_state": lambda step, dmp: dmp.make_eval_fn(),
    "half_batch": _half_batch,
    "altered_loss": _altered_loss,
}


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_sound_run_is_correct(workload):
    r = tiny_run(workload)
    res = _driver(r).run(r)
    assert res.attempted > 0
    assert _correct(workload, res), res.numbers


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_fault_is_not_correct(workload, fault):
    r = tiny_run(workload)
    res = _driver(r).run(r, wrap_step=TRAIN_FAULTS[fault])
    assert not _correct(workload, res), res.numbers


@pytest.mark.parametrize("kind",
                         registry.module("drivers", "train").REFERENCE_KINDS)
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_train_reference_in_the_programs_place(workload, kind):
    """The control (TF32) and the faults planted in the reference, as the
    chip readings take them, fail the cell's limits."""
    r = tiny_run(workload)
    numbers = _driver(r).reference_numbers(r, kind)
    ok, _ = check.judge(numbers, registry.data("limits", workload))
    assert not ok, numbers


def _half_scores(predict):
    def f(dense, sb):
        from torchrec_tpu_torch.sparse import PaddedSparseBatch

        n = dense.shape[0] // 2
        half = PaddedSparseBatch(ids=sb.ids[:, :n], lengths=sb.lengths[:, :n],
                                 keys=sb.keys)
        out = predict(dense[:n], half)
        return torch.cat([out, torch.zeros_like(out)])
    return f


def _altered_score(predict):
    def f(dense, sb):
        out = predict(dense, sb).clone()
        out[0] += 1.0
        return out
    return f


SCORE_FAULTS = {"half_batch": _half_scores, "altered_score": _altered_score}


@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_score_sound_run_is_correct(workload):
    r = tiny_run(workload, sample_every=4)
    res = _driver(r).run(r)
    assert res.attempted > 0 and res.failed == 0
    assert _correct(workload, res), res.numbers


@pytest.mark.parametrize("fault", sorted(SCORE_FAULTS))
@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_score_fault_is_not_correct(workload, fault):
    r = tiny_run(workload, sample_every=4)
    res = _driver(r).run(r, wrap_predict=SCORE_FAULTS[fault])
    assert not _correct(workload, res), res.numbers


@pytest.mark.parametrize("kind",
                         registry.module("drivers", "score").REFERENCE_KINDS)
@pytest.mark.parametrize("workload", SCORE_CELLS)
def test_score_control_is_not_correct(workload, kind):
    """int4 tables, and TF32 products in the dense model, in the program's
    place fail the cell's limit."""
    r = tiny_run(workload)
    numbers = _driver(r).reference_numbers(r, kind)
    ok, _ = check.judge(numbers, registry.data("limits", workload))
    assert not ok, numbers


# the DLRM cell's configuration with ADAGRAD, element by element, on the
# tables and on the dense layers (the Kaggle DLRM states rowwise Adagrad
# and SGD)
ADAGRAD = {"fused_optimizer": "ADAGRAD", "fused_learning_rate": 0.01,
           "dense_optimizer": "ADAGRAD", "dense_learning_rate": 0.01,
           "dense_eps": 1e-8}
DLRM_TRAIN = "criteo_kaggle_dlrm.train_b65536"


def _adagrad_run():
    r = tiny_run(DLRM_TRAIN)
    return dataclasses.replace(r, cfg={**r.cfg, **ADAGRAD})


def test_dlrm_adagrad_sound_run_is_correct():
    r = _adagrad_run()
    res = _driver(r).run(r)
    assert res.attempted > 0
    assert _correct(DLRM_TRAIN, res), res.numbers


def test_dlrm_adagrad_optimizers_are_built():
    from gpubench.drivers import train

    r = _adagrad_run()
    pool = train.make_pool(r)
    dmp, _, _, _ = train.set_up_program(
        r, pool, train.make_rowsets(r, pool[:train.CHECKED]))
    opt = dmp.dense_optimizer
    assert isinstance(opt, torch.optim.Adagrad)
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["lr"] == 0.01
    (sebc,) = dmp.sharded_ebcs.values()
    for s in sebc.strategies:  # per-element state
        assert s.momentum1.shape[-1] == r.cfg["embedding_dim"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_dlrm_adagrad_fault_is_not_correct(fault):
    r = _adagrad_run()
    res = _driver(r).run(r, wrap_step=TRAIN_FAULTS[fault])
    assert not _correct(DLRM_TRAIN, res), res.numbers


@pytest.mark.parametrize("kind",
                         registry.module("drivers", "train").REFERENCE_KINDS)
def test_dlrm_adagrad_reference_in_the_programs_place(kind):
    r = _adagrad_run()
    numbers = _driver(r).reference_numbers(r, kind)
    ok, _ = check.judge(numbers, registry.data("limits", DLRM_TRAIN))
    assert not ok, numbers
