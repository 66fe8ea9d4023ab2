"""The port's variable batches (parallel/variable_batch.py) against the
JAX package, on the CPU.

`VariableBatch.from_ragged` equals JAX's bit for bit (ids, lengths,
weights, dense, labels, mask and sizes); the masked losses equal JAX's
and give a pad row exactly zero gradient. Then four gloo ranks
(tests/torch_port_tower_cases.py) each feed their padded slice of a
batch of per-rank sizes [3, 1, 4, 2], as JAX's devices do on
`jax.devices()[:4]`: under ROW_WISE, TABLE_WISE and COLUMN_WISE each
rank's pooled rows equal JAX's (pad rows zero) and its block and
momentum after one ROWWISE_ADAGRAD update equal JAX's device r; and
test_variable_batch.py's DMP case (an EBC, a linear head and
masked_bce_with_logits over the global batch's real rows) takes three
steps from the JAX DMP's initial state: the mean of the ranks' losses is
JAX's loss, and logits, head, tables and momentum equal JAX's (rtol 1e-4 /
atol 1e-5, as tests/test_torch_port_train.py holds one device).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_tower_cases as cases
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardedEmbeddingBagCollection as JSEBC
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.variable_batch import VariableBatch as JVB
from torchrec_tpu.parallel.variable_batch import (
    masked_bce_with_logits as j_masked_bce,
)
from torchrec_tpu.parallel.variable_batch import masked_mean as j_masked_mean
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.parallel.variable_batch import (
    VariableBatch,
    masked_bce_with_logits,
    masked_mean,
)
from torchrec_tpu_torch.sparse import PaddedSparseBatch

N = len(cases.VB_SIZES)


def _jax_parts():
    return [JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
                 keys=("f0", "f1")) for ids, lengths in cases.vb_parts()]


def _jax_vb():
    rng = np.random.RandomState(5)
    parts = _jax_parts()
    labels = [(rng.rand(p.batch_size) > 0.5).astype(np.float32)
              for p in parts]
    return JVB.from_ragged(parts, label_parts=labels)


@pytest.mark.parametrize("budget", [None, 6], ids=["largest", "budget_6"])
def test_from_ragged_matches_jax_bit_for_bit(budget):
    rng = np.random.RandomState(11)
    parts, jparts, dense, labels = [], [], [], []
    for ids, lengths in cases.vb_parts(seed=9):
        w = rng.rand(*ids.shape).astype(np.float32)
        parts.append(PaddedSparseBatch(
            torch.as_tensor(ids), torch.as_tensor(lengths), ("f0", "f1"),
            torch.as_tensor(w)))
        jparts.append(JPSB(jnp.asarray(ids), jnp.asarray(lengths),
                           ("f0", "f1"), jnp.asarray(w)))
        dense.append(rng.randn(ids.shape[1], 3).astype(np.float32))
        labels.append(rng.randint(0, 2, ids.shape[1]).astype(np.float32))
    got = VariableBatch.from_ragged(parts, dense, labels, batch_size=budget,
                                    device="cpu")
    want = JVB.from_ragged(jparts, dense, labels, batch_size=budget)
    for a, b in ((got.sparse.ids, want.sparse.ids),
                 (got.sparse.lengths, want.sparse.lengths),
                 (got.sparse.weights, want.sparse.weights),
                 (got.dense, want.dense), (got.labels, want.labels),
                 (got.example_mask, want.example_mask),
                 (got.batch_size_per_device, want.batch_size_per_device)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.sparse.keys == want.sparse.keys
    assert got.padded_batch_per_device == want.padded_batch_per_device
    with pytest.raises(ValueError, match="exceeds budget"):
        VariableBatch.from_ragged(parts, batch_size=3, device="cpu")


def test_masked_losses_match_jax_and_leave_pad_rows_no_gradient():
    logits = np.asarray([0.5, -1.0, 2.0, 3.0, -0.25], np.float32)
    labels = np.asarray([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    mask = np.asarray([1.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    z = torch.tensor(logits, requires_grad=True)
    loss = masked_bce_with_logits(z, torch.tensor(labels),
                                  torch.tensor(mask))
    np.testing.assert_allclose(
        loss.item(), float(j_masked_bce(jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        jnp.asarray(mask))), rtol=1e-6)
    np.testing.assert_allclose(
        masked_mean(torch.tensor([1.0, 2.0, 3.0, 100.0, 7.0]),
                    torch.tensor(mask)).item(),
        float(j_masked_mean(jnp.asarray([1.0, 2.0, 3.0, 100.0, 7.0]),
                            jnp.asarray(mask))))
    assert masked_mean(torch.ones(2), torch.zeros(2)).item() == 0.0
    loss.backward()
    jgrad = jax.grad(lambda x: j_masked_bce(x, jnp.asarray(labels),
                                            jnp.asarray(mask)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    assert z.grad[3].item() == 0.0 and z.grad[4].item() == 0.0
    # at z = 0 the gradient is JAX's, -y (jnp.abs' slope +1 at 0), not
    # sigmoid(0) - y
    z0 = torch.zeros(2, requires_grad=True)
    masked_bce_with_logits(z0, torch.tensor([1.0, 0.0]),
                           torch.ones(2)).backward()
    jz0 = jax.grad(lambda x: j_masked_bce(x, jnp.asarray([1.0, 0.0]),
                                          jnp.ones(2)))(jnp.zeros(2))
    np.testing.assert_array_equal(z0.grad.numpy(), np.asarray(jz0))
    assert z0.grad.tolist() == [-0.5, 0.0]
    # a count of the global batch's rows / n: n such losses average to it
    half = masked_mean(torch.tensor([1.0, 2.0, 3.0, 100.0, 7.0]),
                       torch.tensor(mask), count=1.5)
    assert half.item() == 4.0


class JVbModel(fnn.Module):
    ebc: JEBC

    @fnn.compact
    def __call__(self, sb, labels, example_mask):
        logits = fnn.Dense(1)(self.ebc(sb).values)[:, 0]
        loss = j_masked_bce(logits, labels, example_mask)
        return loss, (loss, logits)


def _jax_tables():
    return tuple(JConfig(num_embeddings=r, embedding_dim=cases.VB_DIM,
                         name=f"t{i}", feature_names=[f"f{i}"])
                 for i, r in enumerate(cases.VB_ROWS))


def _jax_dmp():
    plan = JPlan({cases.VB_KEY: {f"t{i}": JPS(JST.ROW_WISE)
                                 for i in range(len(cases.VB_ROWS))}})
    return JDMP(JVbModel(ebc=JEBC(tables=_jax_tables(),
                                  max_feature_length=cases.L)),
                env=JEnv.from_devices(jax.devices()[:N]), plan=plan,
                fused_optim=JOptim.ROWWISE_ADAGRAD,
                fused_params={"learning_rate": cases.VB_FUSED_LR},
                dense_optimizer=optax.sgd(cases.VB_DENSE_LR))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_dmp_run():
    """The JAX DMP's initial state, and its losses, logits and state over
    VB_STEPS steps."""
    jdmp, vb = _jax_dmp(), _jax_vb()
    args = (vb.sparse, vb.labels, vb.example_mask)
    state = jdmp.init(jax.random.PRNGKey(0), *args)
    init = {**{f"dense/{k}": v for k, v in _flat(
        jax.tree.map(np.asarray, state.dense_params)).items()},
        **{f"table/{k}": np.asarray(v) for k, v in jdmp.sharded_ebcs[
            cases.VB_KEY].unshard_to_dense(
                state.emb_states[cases.VB_KEY]).items()}}
    step = jdmp.make_train_step(donate=False)
    losses, logits = [], []
    for _ in range(cases.VB_STEPS):
        state, loss, aux = step(state, *args)
        losses.append(float(loss))
        logits.append(np.asarray(aux[1]))
    return jdmp, init, losses, logits, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_dmp_run):
    d = tmp_path_factory.mktemp("vb")
    np.savez(d / "vb_init.npz", **jax_dmp_run[1])
    return cases.spawn("vb", N, d)


@pytest.mark.parametrize("st", cases.VB_STRATEGIES)
def test_variable_batch_strategy_at_world_size_4_matches_jax(ranks, st):
    cfgs = _jax_tables()
    plan = {c.name: JPS(JST[st], ranks=[i % N] if st == "TABLE_WISE"
                        else None) for i, c in enumerate(cfgs)}
    sebc = JSEBC(JEnv.from_devices(jax.devices()[:N]), cfgs, plan,
                 optim=JOptim.ROWWISE_ADAGRAD,
                 optim_kwargs={"eps": cases.EPS})
    states = sebc.shard_from_dense(cases.vb_tables(cases.case_seed("vb", st)))
    vb = _jax_vb()
    fwd = np.asarray(jax.jit(sebc.forward)(states, vb.sparse).values)
    d = cases.vb_cotangent(np.asarray(vb.example_mask))
    (new,) = jax.jit(sebc.update)(states, vb.sparse, jnp.asarray(d),
                                  cases.LR)
    b = vb.padded_batch_per_device
    for r, out in enumerate(ranks):
        got = out[f"vb/{st}/forward"]
        np.testing.assert_allclose(got, fwd[r * b:(r + 1) * b], rtol=1e-6,
                                   atol=1e-7, err_msg=f"rank {r}")
        assert not got[cases.VB_SIZES[r]:].any()  # pad rows pool to zeros
        np.testing.assert_allclose(out[f"vb/{st}/weights"],
                                   np.asarray(new.weights)[r:r + 1],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"vb/{st}/momentum1"],
                                   np.asarray(new.opt.momentum1)[r:r + 1],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        assert not bool(out["jax_imported"])


def test_variable_batch_dmp_at_world_size_4_matches_jax(ranks, jax_dmp_run):
    from torchrec_tpu_torch.utils.jax_bridge import flax_dense_to_state_dict

    jdmp, _, losses, logits, state = jax_dmp_run
    b = _jax_vb().padded_batch_per_device
    for s in range(cases.VB_STEPS):
        got = np.mean([out[f"vb/dmp/loss{s}"] for out in ranks])
        np.testing.assert_allclose(got, losses[s], rtol=1e-4)
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out[f"vb/dmp/logits{s}"],
                                       logits[s][r * b:(r + 1) * b],
                                       rtol=1e-4, atol=1e-5)
            calls = {k.split("/")[-1]: int(v) for k, v in out.items()
                     if k.startswith(f"vb/dmp/step{s}/calls/") and int(v)}
            assert calls == {"all_gather": 3, "reduce_scatter": 1,
                             "all_reduce_mean": 1}
    assert losses[-1] < losses[0]
    port_model = cases.build_vb_dmp(
        __import__("torchrec_tpu_torch.parallel", fromlist=["x"])
        .ShardingEnv("cpu")).module
    head = flax_dense_to_state_dict(jax.tree.map(
        np.asarray, dict(state.dense_params)), port_model)
    jtables = jdmp.sharded_ebcs[cases.VB_KEY].unshard_to_dense(
        state.emb_states[cases.VB_KEY])
    jopt = {}
    for strat, group in zip(jdmp.sharded_ebcs[cases.VB_KEY].strategies,
                            state.emb_states[cases.VB_KEY]):
        jopt.update(strat.unshard_opt_to_tables(group.opt))
    for r, out in enumerate(ranks):
        for name, v in head.items():
            np.testing.assert_allclose(out[f"vb/dmp/param/{name}"], v,
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        for name, v in jtables.items():
            np.testing.assert_allclose(out[f"vb/dmp/table/{name}"],
                                       np.asarray(v), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(out[f"vb/dmp/m1/{name}"],
                                       np.asarray(jopt[name]["m1__row"]),
                                       rtol=1e-4, atol=1e-5)
