"""The port's training step against the JAX package, on the CPU.

A JAX DistributedModelParallel over DLRMTrain (one device, every table
ROW_WISE) and the port's DMP on device="cpu" start from the same weights,
bridged as numpy through utils/jax_bridge.py, and take three steps on the
same batches: fused_params {"learning_rate": 0.1} and a dense SGD at
0.05, as bench.py trains. The small tables (50/131/77 rows, B=32) make
duplicate ids within a batch common; L=3 adds a MEAN table and empty bags.
Both sides run their CPU routes: JAX its XLA fused update, the port the
plain versions of K2-K5 behind the same dispatch as on the card.

Tolerances: the loss rtol 1e-4 / atol 1e-5 and the dense parameters and
tables atol 1e-5 (rtol 1e-4), as the serving test holds the forward: the
MLP, Gram and gradient sums run in another order, and duplicate rows'
gradients are combined per run here and per token in JAX's SGD. The
rowwise momentum, a sum of mean(g^2), is held to rtol 1e-4 / atol 1e-9.
Momentum round trips through the bridge are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_dlrm import (
    B,
    DENSE_ARCH,
    DENSE_IN,
    JAX_KEY,
    OVER_ARCH,
    PORT_KEY,
    ROWS,
    _request,
    _table_args,
)
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    load_jax_weights,
    rowwise_momentum,
)

FUSED_LR, DENSE_LR, STEPS = 0.1, 0.05, 3
KEYS = [f"f{i}" for i in range(len(ROWS))]


def _jax_dmp(L, mean, optim, lr_schedule=None):
    args, pooling = _table_args(mean)
    tables = tuple(JConfig(**a, pooling=JPooling[p])
                   for a, p in zip(args, pooling))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=L),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH))
    fused = {"learning_rate": FUSED_LR}
    if lr_schedule is not None:
        fused["lr_schedule"] = lr_schedule
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                      for t in tables}}),
                fused_optim=JOptim[optim], fused_params=fused,
                dense_optimizer=optax.sgd(DENSE_LR))


def _port_dmp(L, mean, optim, lr_schedule=None):
    args, pooling = _table_args(mean)
    tables = [EmbeddingBagConfig(**a, pooling=PoolingType[p])
              for a, p in zip(args, pooling)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=L, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta"))
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType.ROW_WISE) for t in tables}})
    fused = {"learning_rate": FUSED_LR}
    if lr_schedule is not None:
        fused["lr_schedule"] = lr_schedule
    return DistributedModelParallel(
        model, plan=plan, device="cpu", fused_optim=EmbOptimType[optim],
        fused_params=fused,
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _jax_momentum(jdmp, state):
    strat = jdmp.sharded_ebcs[JAX_KEY].strategies[0]
    return strat.unshard_rowwise(
        np.asarray(state.emb_states[JAX_KEY][0].opt.momentum1))


def _halving(step):
    return FUSED_LR / (1.0 + step)


@pytest.mark.parametrize("optim,L,mean,schedule", [
    ("EXACT_SGD", 1, False, None),
    ("EXACT_SGD", 3, True, None),
    ("ROWWISE_ADAGRAD", 1, False, None),
    ("ROWWISE_ADAGRAD", 3, True, None),
    ("ROWWISE_ADAGRAD", 1, False, _halving),
])
def test_train_steps_match_jax(optim, L, mean, schedule):
    batches = [_request(L, seed=10 * L + s) for s in range(STEPS)]
    ids, lengths, dense, labels = batches[0]
    jdmp = _jax_dmp(L, mean, optim, schedule)
    sb0 = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                            jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense), sb0,
                      jnp.asarray(labels))
    dmp = _port_dmp(L, mean, optim, schedule)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]))

    jstep = jdmp.make_train_step()
    step = dmp.make_train_step()
    launches = (tl.LAUNCHES, dict(fk.LAUNCHES))
    for ids, lengths, dense, labels in batches:
        sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                               jnp.asarray(lengths)).to_padded(L)
        state, jloss, _ = jstep(state, jnp.asarray(dense), sb,
                                jnp.asarray(labels))
        loss, (_, logits, _) = step(
            torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
                KEYS, ids, lengths), torch.as_tensor(labels))
        assert not loss.requires_grad and logits.shape == (B,)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-5)
    assert (tl.LAUNCHES, fk.LAUNCHES) == launches  # plain versions only
    assert dmp.step == STEPS

    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params))
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name in jtables:
        np.testing.assert_allclose(tables[name], np.asarray(jtables[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    assert int(strat.step) == STEPS
    if optim == "ROWWISE_ADAGRAD":
        jm = _jax_momentum(jdmp, state)
        m = rowwise_momentum(dmp)
        assert m.keys() == jm.keys()
        for name in jm:
            assert np.asarray(jm[name]).max() > 0
            np.testing.assert_allclose(m[name], np.asarray(jm[name]),
                                       rtol=1e-4, atol=1e-9, err_msg=name)
    else:
        assert strat.momentum1 is None and rowwise_momentum(dmp) == {}


def test_rowwise_momentum_round_trips_through_bridge():
    L = 1
    ids, lengths, dense, labels = _request(L, seed=3)
    jdmp = _jax_dmp(L, False, "ROWWISE_ADAGRAD")
    sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(1), jnp.asarray(dense), sb,
                      jnp.asarray(labels))
    jstrat = jdmp.sharded_ebcs[JAX_KEY].strategies[0]
    rng = np.random.RandomState(4)
    jm = {t: rng.rand(r).astype(np.float32)
          for t, r in zip(["t0", "t1", "t2"], ROWS)}
    jm_packed = np.asarray(jstrat.shard_rowwise(jm))

    dmp = _port_dmp(L, False, "ROWWISE_ADAGRAD")
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]), momentum=jm)
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    # the port's [n, rows_loc] momentum is the JAX layout, bit for bit
    np.testing.assert_array_equal(strat.momentum1.numpy(), jm_packed)
    back = rowwise_momentum(dmp)
    assert back.keys() == jm.keys()
    for name in jm:
        np.testing.assert_array_equal(back[name], jm[name])
    # and the JAX side reads the port's packing back unchanged
    again = jstrat.unshard_rowwise(strat.momentum1.numpy())
    for name in jm:
        np.testing.assert_array_equal(np.asarray(again[name]), jm[name])
    # the momentum is a buffer: load_state_dict carries it
    other = _port_dmp(L, False, "ROWWISE_ADAGRAD").init(0)
    other.load_state_dict(dmp.state_dict())
    for name in jm:
        np.testing.assert_array_equal(rowwise_momentum(other)[name],
                                      jm[name])


def test_init_zeroes_the_optimizer_state():
    dmp = _port_dmp(1, False, "ROWWISE_ADAGRAD").init(0)
    ids, lengths, dense, labels = _request(1, seed=5)
    dmp.make_train_step()(torch.as_tensor(dense),
                          KeyedJaggedTensor.from_lengths(KEYS, ids, lengths),
                          torch.as_tensor(labels))
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    assert strat.momentum1.abs().sum() > 0 and int(strat.step) == 1
    dmp.init(0)
    assert strat.momentum1.abs().sum() == 0 and int(strat.step) == 0
    assert dmp.step == 0
