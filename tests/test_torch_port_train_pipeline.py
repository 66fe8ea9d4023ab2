"""The port's TrainPipeline and EvalPipeline against the JAX package's, on
the CPU.

On the CPU a pipeline has no side stream and copies nothing: it reads the
iterator `prefetch_depth` batches ahead and steps on each batch as it
came. A DLRMTrain DMP (ROW_WISE and TABLE_ROW_WISE groups) loaded from the
JAX DMP's initial state trains 3 batches through TrainPipeline and gives
the losses of the same steps taken by hand bit for bit, and JAX's
TrainPipeline's within rtol 1e-4 / atol 1e-5 (test_torch_port_train.py's
bound); EvalPipeline gives make_eval_fn's logits bit for bit and JAX's
EvalPipeline's within the same bound. The CUDA copy path (pinned memory,
side stream, record_stream) runs only on the card, in chip_smoke.py's
phase 17.
"""

import copy

import numpy as np
import pytest
import torch

from test_torch_port_strategies import (
    _dlrm_pair,
    _jax_args,
    _mixed_request,
    _port_args,
)
from torchrec_tpu.parallel.train_pipeline import EvalPipeline as JEval
from torchrec_tpu.parallel.train_pipeline import TrainPipeline as JTrain
from torchrec_tpu_torch.parallel.train_pipeline import (
    EvalPipeline,
    TrainPipeline,
    _map_tensors,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

PLAN = ("ROW_WISE", "TABLE_ROW_WISE", "ROW_WISE", "TABLE_ROW_WISE")
MODEL = dict(rtol=1e-4, atol=1e-5)


class _Counted:
    """An iterator over `items` that records how many it has handed out."""

    def __init__(self, items):
        self.items, self.taken = list(items), 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.taken == len(self.items):
            raise StopIteration
        self.taken += 1
        return self.items[self.taken - 1]


def test_train_pipeline_matches_steps_by_hand_and_jax():
    jdmp, state, dmp = _dlrm_pair("ROWWISE_ADAGRAD", PLAN)
    by_hand = copy.deepcopy(dmp)
    reqs = [_mixed_request(50 + s) for s in range(3)]
    jstep = jdmp.make_train_step()
    jpipe = JTrain(lambda st, batch: jstep(st, *batch), state)
    jit = iter([_jax_args(r) for r in reqs])
    jlosses = [float(jpipe.progress(jit)[0]) for _ in reqs]
    jpipe.close()
    pipe = TrainPipeline(dmp.make_train_step(), prefetch_depth=2,
                         device="cpu")
    it = _Counted([_port_args(r) for r in reqs])
    losses = []
    for s in range(3):
        losses.append(float(pipe.progress(it)[0]))
        assert it.taken == min(s + 3, 3)  # the batch and two ahead
    with pytest.raises(StopIteration):
        pipe.progress(it)
    step = by_hand.make_train_step()
    assert losses == [float(step(*_port_args(r))[0]) for r in reqs]
    np.testing.assert_allclose(losses, jlosses, **MODEL)


def test_eval_pipeline_matches_eval_fn_and_jax():
    jdmp, state, dmp = _dlrm_pair("EXACT_SGD", PLAN)
    reqs = [_mixed_request(60 + s) for s in range(3)]
    jeval = jdmp.make_eval_fn()
    jpipe = JEval(lambda st, batch: jeval(st, *batch), state)
    jit = iter([_jax_args(r) for r in reqs])
    pipe = EvalPipeline(dmp.make_eval_fn(), device="cpu")
    it = iter([_port_args(r) for r in reqs])
    eval_fn = dmp.make_eval_fn()
    for req in reqs:
        _, (_, logits, _) = pipe.progress(it)
        _, (_, jlogits, _) = jpipe.progress(jit)
        torch.testing.assert_close(logits, eval_fn(*_port_args(req))[1][1],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL)
    with pytest.raises(StopIteration):
        pipe.progress(it)


def test_a_cpu_pipeline_copies_nothing():
    """On the CPU the step gets the batch's own tensors; `_map_tensors`
    reaches every tensor of a tuple of a tensor and a KeyedJaggedTensor
    (what the CUDA path copies and marks with record_stream)."""
    seen = []
    pipe = TrainPipeline(lambda *batch: seen.append(batch) or (0, None),
                         device="cpu")
    kjt = KeyedJaggedTensor.from_lengths(["f0"], [1, 2], [1, 1])
    batch = (torch.ones(2, 3), kjt)
    pipe.progress(iter([batch]))
    assert seen[0][0] is batch[0] and seen[0][1] is kjt
    found = []
    moved = _map_tensors(batch, lambda t: found.append(t) or t + 0)
    assert any(t is kjt.values for t in found)
    assert any(t is kjt.lengths for t in found)
    assert isinstance(moved[1], KeyedJaggedTensor)
    assert torch.equal(moved[1].values, kjt.values)
    assert moved[1].values is not kjt.values
