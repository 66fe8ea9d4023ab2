"""The port's EmbeddingCollection, sharded EmbeddingCollection and BERT4Rec
against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both sides; weights
and optimizer state go from the JAX side to the port through
utils/jax_bridge.py. The model is BERT4Rec at a small width: vocab 60
(pad id 0, MASK 59), L=8, D=16, 2 heads, 2 blocks, B=6, dropout 0.0, with
masked batches built as examples/bert4rec_main.py builds them (left-padded
with 0, lengths L, about 20 % of the real items masked).

Tolerances: unpooled lookups are copies and match exactly; gradients of
the unsharded EC and the sharded EC's update sum duplicate ids in another
order (rtol = atol = 1e-6, and 1e-5 for the optimizer steps); logits,
losses and the three train steps run the transformer's sums in another
order (rtol 1e-4, atol 1e-5), as the DLRM tests hold them. The DMP tests
use a dense SGD on both sides, so that they test the model and the EC path
and not optax against torch Adam rounding; a separate test holds one
`torch.optim.Adam` step to one `optax.adam` step (rtol 1e-5).
"""

import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.models.bert4rec import BERT4Rec as JBERT4Rec
from torchrec_tpu.models.bert4rec import BERT4RecTrain as JBERT4RecTrain
from torchrec_tpu.models.bert4rec import (
    make_item_embedding_collection as jmake_ec,
)
from torchrec_tpu.modules import EmbeddingCollection as JEC
from torchrec_tpu.modules.embedding_configs import EmbeddingConfig as JConfig
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import fused_state_shapes
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.sharded_ec import (
    ShardedEmbeddingCollection as JSEC,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import (
    BERT4Rec,
    BERT4RecTrain,
    make_item_embedding_collection,
)
from torchrec_tpu_torch.models.bert4rec import Dense, LayerNorm
from torchrec_tpu_torch.modules import EmbeddingCollection, EmbeddingConfig
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardedEmbeddingCollection,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_flax_params,
    load_jax_weights,
)

V, L, D, H, NL, B = 60, 8, 16, 2, 2, 6
MASK = V - 1
KEY = "model/ec"  # the flax field path and the port's module path alike
FUSED_LR, DENSE_LR, STEPS, START_STEP = 0.1, 0.05, 3, 5
TIGHT = dict(rtol=1e-6, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)


def _batch(seed, all_pad_row=False):
    """(ids [B, L], labels [B, L]) as bert4rec_main.make_train_batch makes
    them: left-padded sequences of items 1..V-2, each real item masked
    with probability 0.2 and at least one per row."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, L), np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        n = 0 if all_pad_row and b == 1 else rng.randint(1, L + 1)
        s = np.zeros(L, np.int32)
        s[L - n:] = rng.randint(1, V - 1, size=n)
        m = (rng.rand(L) < 0.2) & (s > 0)
        if n and not m.any():
            m[L - 1] = True
        labels[b][m] = s[m]
        ids[b] = np.where(m, MASK, s)
    return ids, labels


def _jsb(ids):
    return JKJT.from_lengths(["item"], jnp.asarray(ids.reshape(-1)),
                             jnp.asarray(np.full(ids.shape[0], ids.shape[1],
                                                 np.int32))).to_padded(L)


def _kjt(ids):
    return KeyedJaggedTensor.from_lengths(
        ["item"], ids.reshape(-1), np.full(ids.shape[0], ids.shape[1],
                                           np.int32))


# -- unsharded EmbeddingCollection -------------------------------------------


def _ec_tables():
    """Two tables, three features (one shared name across tables is
    renamed feature@table, as in the JAX module)."""
    return [dict(num_embeddings=V, embedding_dim=D, name="t0",
                 feature_names=["a", "b"]),
            dict(num_embeddings=37, embedding_dim=D, name="t1",
                 feature_names=["c", "a"])]


def _ec_batch(seed, lo=0, hi=37):
    rng = np.random.RandomState(seed)
    keys = ["a", "b", "c"]
    lengths = rng.randint(0, L + 1, size=len(keys) * B).astype(np.int32)
    values = rng.randint(lo, hi, size=int(lengths.sum())).astype(np.int32)
    return keys, values, lengths


def test_unsharded_ec_and_its_gradient_match_jax():
    keys, values, lengths = _ec_batch(1)
    rng = np.random.RandomState(2)
    tables = {t["name"]: rng.randn(t["num_embeddings"], D).astype(np.float32)
              for t in _ec_tables()}
    jec = JEC(tables=tuple(JConfig(**t) for t in _ec_tables()),
              max_feature_length=L)
    sb = JKJT.from_lengths(keys, jnp.asarray(values),
                           jnp.asarray(lengths)).to_padded(L)
    jparams = {k: jnp.asarray(v) for k, v in tables.items()}
    jout = jec.apply({"params": jparams}, sb)
    cot = {n: rng.randn(B, L, D).astype(np.float32) for n in jout}
    jgrad = jax.grad(lambda p: sum(
        (o * cot[n]).sum()
        for n, o in jec.apply({"params": p}, sb).items()))(jparams)

    ec = EmbeddingCollection([EmbeddingConfig(**t) for t in _ec_tables()],
                             max_feature_length=L, device="cpu")
    load_flax_params(ec, tables)
    launches = tracing.counts()
    out = ec(KeyedJaggedTensor.from_lengths(keys, values, lengths))
    assert out.keys() == jout.keys()
    assert sorted(out) == ["a@t0", "a@t1", "b", "c"]
    for n in jout:
        assert out[n].shape == (B, L, D)
        np.testing.assert_array_equal(out[n].detach().numpy(),
                                      np.asarray(jout[n]))
    sum((out[n] * torch.as_tensor(cot[n])).sum() for n in out).backward()
    assert tracing.counts() == launches  # CPU tensors: plain versions only
    for name, p in ec.embeddings.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad[name]),
                                   **TIGHT)


def test_ec_checks_its_tables():
    with pytest.raises(ValueError, match="embedding_dim"):
        EmbeddingCollection([EmbeddingConfig(10, 4, "x", feature_names=["f"]),
                             EmbeddingConfig(10, 8, "y", feature_names=["g"])],
                            device="cpu")
    ec = EmbeddingCollection([EmbeddingConfig(10, 4, "x",
                                              feature_names=["f"])],
                             device="cpu")
    ec.reset_parameters(torch.Generator().manual_seed(0))
    assert ec.embeddings["x"].abs().max() <= (1 / 10) ** 0.5
    assert ec.embedding_dim == 4 and ec.embedding_names == ["f"]


# -- ShardedEmbeddingCollection ----------------------------------------------


@pytest.mark.parametrize("optim", ["ROWWISE_ADAGRAD", "EXACT_SGD", "ADAM"])
def test_sharded_ec_forward_and_update_match_jax(optim):
    _check_sharded_ec_against_jax(optim, *_ec_batch(3))


@pytest.mark.parametrize("optim", ["ROWWISE_ADAGRAD", "ADAM"])
def test_sharded_ec_out_of_range_ids_match_jax(optim):
    """Ids below 0 and at or above a table's rows (60 and 37) are owned by
    no shard: zero rows and no update, on both sides. Rows are compared by
    value: JAX's mask multiply leaves -0.0 where the port writes +0.0."""
    keys, values, lengths = _ec_batch(13, lo=-70, hi=75)
    assert (values < 0).any() and (values >= 60).any()
    _check_sharded_ec_against_jax(optim, keys, values, lengths)


def _check_sharded_ec_against_jax(optim, keys, values, lengths):
    """Forward, one fused update and the optimizer state of the sharded EC
    against the JAX module, from the same tables and cotangents."""
    rng = np.random.RandomState(4)
    dense = {t["name"]: rng.randn(t["num_embeddings"], D).astype(np.float32)
             for t in _ec_tables()}
    jtables = [JConfig(**t) for t in _ec_tables()]
    jsec = JSEC(JEnv.from_devices(jax.devices()[:1]), jtables,
                {t.name: JPS(JST.ROW_WISE) for t in jtables},
                optim=JOptim[optim])
    sb = JKJT.from_lengths(keys, jnp.asarray(values),
                           jnp.asarray(lengths)).to_padded(L)
    states = jsec.shard_from_dense(dense)
    jout = jsec.forward(states, sb)
    d_tokens = {n: rng.randn(B, L, D).astype(np.float32) for n in jout}
    new_states = jsec.update(states, sb, {n: jnp.asarray(d)
                                          for n, d in d_tokens.items()},
                             FUSED_LR)

    tables = [EmbeddingConfig(**t) for t in _ec_tables()]
    sec = ShardedEmbeddingCollection(
        ShardingEnv("cpu"), tables,
        {t.name: ParameterSharding(ShardingType.ROW_WISE) for t in tables},
        max_feature_length=L, optim=EmbOptimType[optim])
    sec.shard_from_dense(dense)
    # the JAX packed layout, bit for bit
    np.testing.assert_array_equal(sec.states[0].weights.numpy(),
                                  np.asarray(states[0].weights))
    kjt = KeyedJaggedTensor.from_lengths(keys, values, lengths)
    out = sec(kjt)
    assert out.keys() == jout.keys()
    for n in jout:
        np.testing.assert_array_equal(out[n].numpy(), np.asarray(jout[n]))
    sec.update(kjt, {n: torch.as_tensor(d) for n, d in d_tokens.items()},
               FUSED_LR)
    jback = jsec.unshard_to_dense(new_states)
    back = sec.unshard_to_dense()
    for name in jback:
        assert not np.array_equal(back[name], dense[name])  # it moved
        np.testing.assert_allclose(back[name], np.asarray(jback[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jopt = {}
    for strat, g in zip(jsec.strategies, new_states):
        jopt.update(strat.unshard_opt_to_tables(g.opt))
    opt = sec.unshard_opt_to_tables()
    assert opt.keys() == jopt.keys()
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        for tag, ref in jopt[name].items():
            np.testing.assert_allclose(opt[name][tag], np.asarray(ref),
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{name} {tag}")


# -- BERT4Rec ----------------------------------------------------------------


def _jax_model(dropout=0.0):
    return JBERT4Rec(vocab_size=V, max_len=L, emb_dim=D, nhead=H,
                     num_layers=NL, dropout=dropout,
                     ec=jmake_ec(V, D, L))


def test_bert4rec_logits_match_jax():
    ids, _ = _batch(5, all_pad_row=True)
    assert not ids[1].any()  # a sequence of pads only
    jmodel = _jax_model()
    params = jmodel.init(jax.random.PRNGKey(0), _jsb(ids))["params"]
    jlogits = np.asarray(jmodel.apply({"params": params}, _jsb(ids)))

    model = BERT4Rec(V, L, D, H, NL, dropout=0.0, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        logits = model(_kjt(ids))
    assert logits.shape == (B, L, V) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), jlogits, **MODEL)


def _jax_dmp(optim, dense_opt=None, dropout=0.0):
    model = JBERT4RecTrain(model=_jax_model(dropout))
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({KEY: {"item_embedding": JPS(JST.ROW_WISE)}}),
                fused_optim=JOptim[optim],
                fused_params={"learning_rate": FUSED_LR},
                dense_optimizer=dense_opt or optax.sgd(DENSE_LR))


def _port_dmp(optim, device="cpu", dropout=0.0):
    model = BERT4RecTrain(BERT4Rec(
        V, L, D, H, NL, dropout=dropout,
        ec=make_item_embedding_collection(V, D, L, device="meta"),
        device="meta"))
    return DistributedModelParallel(
        model, plan=ShardingPlan({KEY: {"item_embedding": ParameterSharding(
            ShardingType.ROW_WISE)}}),
        fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR),
        device=device)


def _jax_opt_tables(jdmp, state):
    out = {}
    for strat, g in zip(jdmp.sharded_ebcs[KEY].strategies,
                        state.emb_states[KEY]):
        out.update(strat.unshard_opt_to_tables(g.opt))
    return out


def _seeded_opt(jdmp, state, optim, seed):
    """The JAX state with seeded momenta in [0, 0.01) at step 5 (as the
    DLRM train tests start): from zero momenta the first Adagrad/Adam step
    is lr * sign(g) per element, which would compare summation orders."""
    rng = np.random.RandomState(seed)
    entry = {"step": np.asarray(START_STEP, np.int32)}
    for tag, kind in zip(("m1", "m2"), fused_state_shapes(JOptim[optim])):
        shape = {"row": (V,), "full": (V, D)}.get(kind)
        if shape is not None:
            entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                np.float32)
    groups = tuple(
        g.replace(opt=strat.shard_opt_from_tables({"item_embedding": entry},
                                                  g.opt))
        for strat, g in zip(jdmp.sharded_ebcs[KEY].strategies,
                            state.emb_states[KEY]))
    return state.replace(emb_states={KEY: groups})


def _bridged(optim, seed=0, dropout=0.0):
    ids, labels = _batch(seed)
    jdmp = _jax_dmp(optim, dropout=dropout)
    state = jdmp.init(jax.random.PRNGKey(seed), _jsb(ids),
                      jnp.asarray(labels))
    state = _seeded_opt(jdmp, state, optim, seed)
    dmp = _port_dmp(optim, dropout=dropout)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[KEY].unshard_to_dense(state.emb_states[KEY]),
        opt_state=_jax_opt_tables(jdmp, state))
    return jdmp, state, dmp


def test_dmp_eval_matches_jax():
    jdmp, state, dmp = _bridged("ROWWISE_ADAGRAD", seed=6)
    ids, labels = _batch(7, all_pad_row=True)
    jloss, (_, jlogits) = jdmp.make_eval_fn()(state, _jsb(ids),
                                              jnp.asarray(labels))
    launches = tracing.counts()
    loss, (_, logits) = dmp.make_eval_fn()(_kjt(ids), torch.as_tensor(labels))
    assert tracing.counts() == launches
    assert logits.shape == (B, L, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL)
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL)


@pytest.mark.parametrize("optim", ["ROWWISE_ADAGRAD", "EXACT_SGD", "ADAM"])
def test_dmp_train_steps_match_jax(optim):
    _check_train_steps(optim, dropout=0.0)


def test_dmps_train_deterministic_with_dropout():
    """A BERT4Rec with dropout 0.1 under both DMPs: neither passes a
    dropout rng (the models' default deterministic=True), so the three
    steps agree as at dropout 0."""
    _check_train_steps("ROWWISE_ADAGRAD", dropout=0.1)


def _check_train_steps(optim, dropout):
    jdmp, state, dmp = _bridged(optim, seed=8, dropout=dropout)
    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    start = dmp.sharded_ebcs[KEY].unshard_to_dense()["item_embedding"]
    launches = tracing.counts()
    touched = np.zeros(V, bool)
    for s in range(STEPS):
        ids, labels = _batch(20 + s)
        touched[ids.reshape(-1)] = True
        state, jloss, _ = jstep(state, _jsb(ids), jnp.asarray(labels))
        loss, (_, logits) = step(_kjt(ids), torch.as_tensor(labels))
        assert not loss.requires_grad and logits.shape == (B, L, V)
        np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
    assert tracing.counts() == launches  # plain versions only
    assert dmp.step == STEPS

    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   err_msg=name, **MODEL)
    jtable = jdmp.sharded_ebcs[KEY].unshard_to_dense(
        state.emb_states[KEY])["item_embedding"]
    table = dmp.sharded_ebcs[KEY].unshard_to_dense()["item_embedding"]
    np.testing.assert_allclose(table, np.asarray(jtable), **MODEL)
    jopt, opt = _jax_opt_tables(jdmp, state), fused_optimizer_state(dmp)
    assert int(opt["item_embedding"]["step"]) == START_STEP + STEPS
    for tag, ref in jopt["item_embedding"].items():
        atol = 1e-9 if tag.endswith("__row") else 1e-5
        np.testing.assert_allclose(opt["item_embedding"][tag],
                                   np.asarray(ref), rtol=1e-4, atol=atol,
                                   err_msg=tag)
    # rows no batch touched are unchanged
    assert (~touched).any()
    np.testing.assert_array_equal(table[~touched], start[~touched])


@pytest.mark.parametrize("steps", [1, 3])
def test_torch_adam_matches_optax_adam(steps):
    """The dense optimizer of the example: optax.adam(1e-3) and
    torch.optim.Adam(lr=1e-3) add eps after the square root of the
    bias-corrected second moment alike."""
    rng = np.random.RandomState(steps)
    p0 = rng.randn(40, 7).astype(np.float32)
    grads = [rng.randn(40, 7).astype(np.float32) for _ in range(steps)]
    opt = optax.adam(1e-3)
    jp = jnp.asarray(p0)
    jstate = opt.init(jp)
    for g in grads:
        upd, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.Adam([tp], lr=1e-3)
    for g in grads:
        tp.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=0)


def test_bridge_loads_both_models_by_name():
    """The flax trees of the DLRM and BERT4Rec DMPs load with no missing
    or unexpected names; a block's Dense_0 / Dense_1 are its feed-forward
    layers, a Perceptron's Dense_0 its linear."""
    from test_torch_port_dlrm import _port_dmp as dlrm_port_dmp
    from test_torch_port_dlrm import _jax_dmp as dlrm_jax_dmp
    from test_torch_port_dlrm import _request

    _, state, _ = dlrm_jax_dmp(1, False, *_request(1, seed=0))
    dlrm = dlrm_port_dmp(1, False)
    flat = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dlrm.module)
    assert flat.keys() == dict(dlrm.module.named_parameters()).keys()
    assert "dlrm.over_arch.head.linear.weight" in flat

    ids, labels = _batch(0)
    jdmp = _jax_dmp("ROWWISE_ADAGRAD")
    jstate = jdmp.init(jax.random.PRNGKey(0), _jsb(ids), jnp.asarray(labels))
    dense = jax.tree.map(np.asarray, jstate.dense_params)
    dmp = _port_dmp("ROWWISE_ADAGRAD")
    flat = flax_dense_to_state_dict(dense, dmp.module)
    assert flat.keys() == dict(dmp.module.named_parameters()).keys()
    blk = dense["model"]["block_1"]
    np.testing.assert_array_equal(flat["model.blocks.1.ff_in.weight"],
                                  blk["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(flat["model.blocks.1.ff_out.bias"],
                                  blk["Dense_1"]["bias"])
    q = blk["MultiHeadDotProductAttention_0"]["query"]
    np.testing.assert_array_equal(
        flat["model.blocks.1.attention.query.weight"],
        q["kernel"].reshape(D, D).T)
    np.testing.assert_array_equal(flat["model.history.positional"],
                                  dense["model"]["history"]["positional"])
    bad = {"model": {"block_0": {"Dense_2": blk["Dense_0"]}}}
    with pytest.raises(ValueError, match="Dense_2"):
        flax_dense_to_state_dict(bad, dmp.module)


def test_dmp_init_draws_from_flax_initializers():
    dmp = _port_dmp("ROWWISE_ADAGRAD").init(3)
    model = dmp.module.model
    pos = model.history.positional.detach()
    assert abs(pos.std().item() - 1.0) < 0.3
    for m in model.modules():
        if isinstance(m, Dense):
            std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
            assert m.weight.abs().max() <= 2 * std + 1e-6
            assert not m.bias.any()
        elif isinstance(m, LayerNorm):
            assert m.weight.eq(1).all() and not m.bias.any()
            assert m.eps == 1e-6
    table = dmp.sharded_ebcs[KEY].unshard_to_dense()["item_embedding"]
    assert table.shape == (V, D) and np.abs(table).max() <= (1 / V) ** 0.5
    again = _port_dmp("ROWWISE_ADAGRAD").init(3)
    for a, b in zip(dmp.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    # a parameter no module draws makes init raise
    dmp.module.model.extra = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="extra"):
        dmp.init(0)


def test_dmp_swaps_every_reference_to_the_ec():
    dmp = _port_dmp("ROWWISE_ADAGRAD")
    model = dmp.module.model
    assert list(dmp.sharded_ebcs) == [KEY]
    assert model.ec is model.history.ec is dmp.sharded_ebcs[KEY]
    assert isinstance(model.ec, ShardedEmbeddingCollection)
    assert not any(isinstance(m, EmbeddingCollection)
                   for m in dmp.modules())


# -- dropout -------------------------------------------------------------------


def test_bert4rec_with_dropout_deterministic_matches_jax():
    ids, _ = _batch(11)
    jmodel = _jax_model(dropout=0.1)
    params = jmodel.init(jax.random.PRNGKey(1), _jsb(ids))["params"]
    jlogits = np.asarray(jmodel.apply({"params": params}, _jsb(ids),
                                      deterministic=True))
    model = BERT4Rec(V, L, D, H, NL, dropout=0.1, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        logits = model(_kjt(ids))  # deterministic by default
    np.testing.assert_allclose(logits.numpy(), jlogits, **MODEL)


def _dropped(seed, deterministic=False):
    model = BERT4Rec(V, L, D, H, NL, dropout=0.1, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, _jax_model(0.1).init(
        jax.random.PRNGKey(2), _jsb(_batch(12)[0]))["params"]))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return model(_kjt(_batch(13)[0]), deterministic=deterministic,
                     generator=gen)


def test_dropout_same_seed_same_output():
    a, b, c = _dropped(0), _dropped(0), _dropped(1)
    det = _dropped(0, deterministic=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, det)
    assert torch.isfinite(a).all()
    with pytest.raises(ValueError, match="Generator"):
        BERT4Rec(V, L, D, H, NL, dropout=0.1, device="cpu")(
            _kjt(_batch(13)[0]), deterministic=False)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_within_binomial_bounds(rate):
    """Kept fraction within 5 sigma of 1 - rate over 2^18 draws, kept
    values x / keep (the same float32 as flax's), dropped ones 0; flax's
    Dropout on the same input gives the same two values."""
    from torchrec_tpu_torch.models.bert4rec import dropout

    n, keep = 1 << 18, 1.0 - rate
    x = torch.full((n,), 0.7)
    out = dropout(x, rate, False, torch.Generator().manual_seed(3))
    kept = out != 0
    sigma = (n * keep * (1 - keep)) ** 0.5
    assert abs(int(kept.sum()) - n * keep) < 5 * sigma
    want = np.float32(0.7) / np.float32(keep)
    assert (out[kept] == torch.tensor(want)).all()
    jout = np.asarray(fnn.Dropout(rate).apply(
        {}, jnp.full((n,), 0.7, jnp.float32), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(3)}))
    assert set(np.unique(jout)) == {np.float32(0.0), want}
    assert abs(int((jout != 0).sum()) - n * keep) < 5 * sigma
    # no draw at rate 0 or when deterministic; all dropped at rate 1
    assert dropout(x, 0.0, False, None) is x
    assert dropout(x, rate, True, None) is x
    assert not dropout(x, 1.0, False, torch.Generator()).any()
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, rate, False, None)


def test_attention_dropout_mask_is_shared_across_batch_and_heads():
    """flax draws the attention dropout once per [L, L] and broadcasts it
    over the batch and the heads (broadcast_dropout=True), multiplying the
    weights by keep / keep_prob: recomputed here from the same generator
    seed."""
    from torchrec_tpu_torch.models.bert4rec import (
        MultiHeadDotProductAttention,
    )

    rate, Bx = 0.3, 5
    attn = MultiHeadDotProductAttention(H, D, D, rate, device="cpu")
    for m in (attn.query, attn.key, attn.value, attn.out):
        m.reset_parameters(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(Bx, L, D).astype(np.float32))
    mask = torch.from_numpy(rng.rand(Bx, 1, 1, L) < 0.8).expand(Bx, 1, L, L)
    with torch.no_grad():
        got = attn(x, mask, False, torch.Generator().manual_seed(6))
        keep = torch.rand((1, 1, L, L),
                          generator=torch.Generator().manual_seed(6)) < (
                              1 - rate)
        assert 0 < int(keep.sum()) < L * L

        def heads(t):
            return t.reshape(Bx, L, H, -1)

        q, k, v = (heads(m(x)) for m in (attn.query, attn.key, attn.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q / (D // H) ** 0.5, k)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, -1) * (keep.float() / (1 - rate))
        want = attn.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(
            Bx, L, D))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_bert4rec_trains_with_seeded_dropout():
    """Outside the DMP: three Adam steps of BERT4RecTrain with dropout 0.1
    and a seeded generator; the same seed retraces them exactly, another
    seed and deterministic training do not."""

    def train(seed, deterministic=False):
        model = BERT4RecTrain(BERT4Rec(V, L, D, H, NL, dropout=0.1,
                                       device="cpu"))
        gen = torch.Generator().manual_seed(0)
        for m in model.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None and "generator" in inspect.signature(
                    reset).parameters:
                reset(generator=gen)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        drop = torch.Generator().manual_seed(seed)
        losses = []
        for s in range(3):
            ids, labels = _batch(30 + s)
            loss, _ = model(_kjt(ids), torch.as_tensor(labels),
                            deterministic=deterministic, generator=drop)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses, [p.detach().clone() for p in model.parameters()]

    (la, pa), (lb, pb) = train(7), train(7)
    (lc, _), (ld, _) = train(8), train(7, deterministic=True)
    assert all(np.isfinite(la)) and la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert la != lc and la != ld
