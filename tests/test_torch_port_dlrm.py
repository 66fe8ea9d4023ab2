"""The port's serving forward against the JAX package, on the CPU.

A JAX DistributedModelParallel over DLRMTrain (one device, every table
ROW_WISE) is initialised; its dense params and unsharded tables go as
numpy through utils/jax_bridge.py into the port's DMP on device="cpu", and
both answer the same request. Tolerances: fp32 logits and loss within
rtol=1e-4, atol=1e-5, since the MLP and Gram sums run in another order;
table round trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
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
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.parallel.strategies import ROW_TILE
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import load_jax_weights

D, DENSE_IN, B = 16, 5, 32
DENSE_ARCH, OVER_ARCH = (16, D), (16, 8, 1)
ROWS = (50, 131, 77)
JAX_KEY = "dlrm/embedding_bag_collection"
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"


def _table_args(mean):
    return [
        dict(num_embeddings=r, embedding_dim=D, name=f"t{i}",
             feature_names=[f"f{i}"])
        for i, r in enumerate(ROWS)
    ], ["MEAN" if mean and i == 1 else "SUM" for i in range(len(ROWS))]


def _request(L, seed):
    rng = np.random.RandomState(seed)
    F = len(ROWS)
    lengths = rng.randint(0 if L > 1 else 1, L + 1, size=F * B)
    ids = np.concatenate([
        rng.randint(0, ROWS[f], size=int(lengths[f * B:(f + 1) * B].sum()))
        for f in range(F)
    ]).astype(np.int32)
    dense = rng.randn(B, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=B).astype(np.float32)
    return ids, lengths.astype(np.int32), dense, labels


def _jax_dmp(L, mean, ids, lengths, dense, labels):
    args, pooling = _table_args(mean)
    tables = tuple(JConfig(**a, pooling=JPooling[p])
                   for a, p in zip(args, pooling))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=L),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH))
    dmp = JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
               plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                     for t in tables}}))
    keys = [f"f{i}" for i in range(len(ROWS))]
    sb = JKJT.from_lengths(keys, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(L)
    state = dmp.init(jax.random.PRNGKey(0), jnp.asarray(dense), sb,
                     jnp.asarray(labels))
    return dmp, state, sb


def _port_dmp(L, mean):
    args, pooling = _table_args(mean)
    tables = [EmbeddingBagConfig(**a, pooling=PoolingType[p])
              for a, p in zip(args, pooling)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=L, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta"))
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType.ROW_WISE) for t in tables}})
    return DistributedModelParallel(model, plan=plan, device="cpu")


@pytest.mark.parametrize("L,mean", [(1, False), (3, True)])
def test_dlrm_eval_forward_matches_jax(L, mean):
    ids, lengths, dense, labels = _request(L, seed=L)
    jdmp, state, sb = _jax_dmp(L, mean, ids, lengths, dense, labels)
    jloss, (_, jlogits, _) = jdmp.make_eval_fn()(
        state, jnp.asarray(dense), sb, jnp.asarray(labels))
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])

    dmp = _port_dmp(L, mean)
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jtables)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(len(ROWS))], ids, lengths)
    launches = tracing.counts()
    loss, (_, logits, _) = dmp.make_eval_fn()(
        torch.as_tensor(dense), kjt, torch.as_tensor(labels))
    assert tracing.counts() == launches
    assert logits.dtype == torch.float32 and logits.shape == (B,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=1e-4, atol=1e-5)

    # the port's shards hold the JAX layout: [1, rows_loc, D] identical
    port_w = dmp.sharded_ebcs[PORT_KEY].states[0].weights
    jax_w = np.asarray(state.emb_states[JAX_KEY][0].weights)
    assert port_w.shape[1] % ROW_TILE == 0
    np.testing.assert_array_equal(port_w.numpy(), jax_w)
    back = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    assert back.keys() == jtables.keys()
    for name in jtables:
        np.testing.assert_array_equal(back[name], jtables[name])


def test_unsharded_ebc_matches_jax():
    L = 3
    args, pooling = _table_args(mean=True)
    jtables = tuple(JConfig(**a, pooling=JPooling[p])
                    for a, p in zip(args, pooling))
    ids, lengths, _, _ = _request(L, seed=7)
    keys = [f"f{i}" for i in range(len(ROWS))]
    jebc = JEBC(tables=jtables, max_feature_length=L)
    sb = JKJT.from_lengths(keys, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(L)
    params = jebc.init(jax.random.PRNGKey(1), sb)
    ref = jebc.apply(params, sb)

    ebc = EmbeddingBagCollection(
        [EmbeddingBagConfig(**a, pooling=PoolingType[p])
         for a, p in zip(args, pooling)],
        max_feature_length=L, device="cpu")
    with torch.no_grad():
        for name, w in params["params"].items():
            ebc.embedding_bags[name].copy_(torch.tensor(np.asarray(w)))
        out = ebc(KeyedJaggedTensor.from_lengths(keys, ids, lengths))
    assert out.keys == ref.keys and out.length_per_key == ref.length_per_key
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-6, atol=1e-6)


def test_port_init_draws_within_table_bounds():
    dmp = _port_dmp(L=1, mean=False).init(seed=3)
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for rows, (name, w) in zip(ROWS, sorted(tables.items())):
        assert w.shape == (rows, D)
        assert np.abs(w).max() <= (1.0 / rows) ** 0.5
    again = _port_dmp(L=1, mean=False).init(seed=3)
    for a, b in zip(dmp.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_dlrm_train_loss_gradient_at_a_zero_logit_matches_jax():
    """DLRMTrain's BCE takes JAX's gradient at a logit of exactly 0 (-y:
    jnp.maximum splits the slope there and jnp.abs takes +1), where
    torch.clamp / torch.abs gave 1 - y."""
    import flax.linen as fnn

    class Logits(torch.nn.Module):
        def forward(self, dense, sparse):
            return dense

    class JLogits(fnn.Module):
        def __call__(self, dense, sparse):
            return dense

    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    x = np.asarray([[0.0], [0.0], [0.5]], np.float32)
    z = torch.tensor(x, requires_grad=True)
    DLRMTrain(Logits())(z, None, torch.tensor(labels))[0].backward()
    jtrain = JDLRMTrain(dlrm=JLogits())
    jgrad = jax.grad(lambda v: jtrain.apply({}, v, None,
                                            jnp.asarray(labels))[0])(
        jnp.asarray(x))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    assert z.grad[:2, 0].tolist() == [np.float32(-1.0 / 3), 0.0]
