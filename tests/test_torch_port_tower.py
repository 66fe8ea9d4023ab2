"""The port's embedding towers (modules/embedding_tower.py,
parallel/tower_sharding.py and the DMP's tower branch) against the JAX
package, on the CPU.

The collection: test_tower.py's three towers run by four gloo ranks
(tests/torch_port_tower_cases.py, towers on ranks 0, 3 and 3, so ranks 1
and 2 hold none) and in this process at world size 1, against JAX's
ShardedEmbeddingTowerCollection on `jax.devices()[:n]` from the same
initial state (JAX's `init`, loaded into the port's tables and
interaction modules through utils/jax_bridge.py): forward, one update
under ROWWISE_ADAGRAD and EXACT_SGD, every interaction parameter, the
rank's block, momentum and step, the round trip, and the collective calls
of each forward and update. A variant pools one table by MEAN and feeds
per-sample weights. Tolerances: the forward and the update rtol 1e-5 /
atol 1e-6 (sums in another order, the interaction's GEMMs another
library's); a rank that holds no tower has a zero block and steps its
step as JAX's device does.

The DMP: test_tower_dmp.py's tower model (two towers, a Dense(1) head,
BCE) from weights bridged out of the JAX DMP at world size 1: the golden
SGD step (logits, loss, tables, interaction parameters, head), three
training steps, a bare EmbeddingTower, the interaction learning rate
staying at the base fused lr under a fused schedule (tables at the
scheduled lr, interactions at the base one, neither in the dense
optimizer), and the refusals of a non-TABLE_WISE plan and of a tower split
over ranks.
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
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_tower import (
    EmbeddingTower as JEmbeddingTower,
)
from torchrec_tpu.modules.embedding_tower import (
    EmbeddingTowerCollection as JEmbeddingTowerCollection,
)
from torchrec_tpu.modules.mlp import MLP as JMLP
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel.tower_sharding import (
    ShardedEmbeddingTowerCollection as JTowers,
)
from torchrec_tpu.parallel.tower_sharding import TowerSpec as JTowerSpec
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.modules import (
    MLP,
    EmbeddingBagCollection,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.modules.embedding_tower import (
    EmbeddingTower,
    EmbeddingTowerCollection,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.parallel.tower_sharding import (
    ShardedEmbeddingTowerCollection,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    load_jax_weights,
)

RTOL, ATOL = 1e-5, 1e-6
CASES = [(v, o) for v in cases.TOWER_VARIANTS for o in cases.TOWER_OPTIMS]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(dict(v), f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_tc(variant, optim, n):
    specs = []
    for (tables, layers), rank in zip(cases.TOWERS, cases.tower_ranks(n)):
        cfgs = tuple(JConfig(
            num_embeddings=r, embedding_dim=cases.DIM, name=name,
            feature_names=list(feats),
            pooling=JPooling.MEAN if mean and variant == "mean_weighted"
            else JPooling.SUM) for r, name, feats, mean in tables)
        specs.append(JTowerSpec(tables=cfgs,
                                interaction=JMLP(layer_sizes=layers),
                                device=rank, d_out=layers[-1]))
    return JTowers(JEnv.from_devices(jax.devices()[:n]), specs,
                   optim=JOptim[optim], optim_kwargs={"eps": cases.EPS})


def _init():
    """JAX's initial tables and interaction parameters of each variant,
    flattened as the ranks read them."""
    out = {}
    for variant in cases.TOWER_VARIANTS:
        tc = _jax_tc(variant, "EXACT_SGD", 1)
        state = tc.init(jax.random.PRNGKey(0), batch_size=cases.B)
        for name, t in tc.unshard_tables_to_dense(state.emb.weights).items():
            out[f"{variant}/table/{name}"] = np.asarray(t)
        for ti, p in enumerate(state.interaction_params):
            for k, v in _flat(jax.tree.map(np.asarray, p)).items():
                out[f"{variant}/inter/{ti}/{k}"] = v
    return out


def _jax_case(variant, optim, n):
    """JAX's forward, and its state after one update, of the case."""
    tc = _jax_tc(variant, optim, n)
    state = tc.init(jax.random.PRNGKey(0), batch_size=cases.B)
    seed = cases.case_seed("tower", variant)
    ids, lengths, w = cases.tower_batch(seed, variant == "mean_weighted")
    sb = JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
              keys=cases.FEATURES,
              weights=None if w is None else jnp.asarray(w))
    fwd = np.asarray(jax.jit(tc.forward)(state, sb))
    new = jax.jit(tc.update)(state, sb,
                             jnp.asarray(cases.tower_cotangent(seed + 1)),
                             cases.LR)
    return tc, fwd, new


@pytest.fixture(scope="module")
def init():
    return _init()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, init):
    d = tmp_path_factory.mktemp("towers")
    np.savez(d / "tower_init.npz", **init)
    return cases.spawn("tower", 4, d)


def _check(outs, variant, optim, n):
    tc, fwd, new = _jax_case(variant, optim, n)
    prefix = f"tower/{variant}/{optim}"
    B_loc = cases.B // n
    weighted = variant == "mean_weighted"
    jw = np.asarray(new.emb.weights)
    jm = new.emb.opt.momentum1
    jtables = tc.unshard_tables_to_dense(new.emb.weights)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{prefix}/forward"],
                                   fwd[r * B_loc:(r + 1) * B_loc],
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{prefix}/weights"], jw[r:r + 1],
                                   rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")
        assert (jm is None) == (f"{prefix}/momentum1" not in out)
        if jm is not None:
            np.testing.assert_allclose(out[f"{prefix}/momentum1"],
                                       np.asarray(jm)[r:r + 1], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r}")
        assert int(out[f"{prefix}/step"]) == int(new.emb.opt.step) == 1
        for ti, (_, layers) in enumerate(cases.TOWERS):
            want = flax_dense_to_state_dict(
                jax.tree.map(np.asarray, dict(new.interaction_params[ti])),
                MLP(cases.tower_d_in(ti), layers, device="meta"))
            assert want
            for name, v in want.items():
                np.testing.assert_allclose(
                    out[f"{prefix}/inter/{ti}/{name}"], v, rtol=RTOL,
                    atol=ATOL, err_msg=f"rank {r} tower {ti} {name}")
        for name, v in jtables.items():
            np.testing.assert_allclose(out[f"{prefix}/table/{name}"],
                                       np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {name}")
        assert bool(out[f"{prefix}/roundtrip"])
        calls = {k.split("/")[-1]: int(v) for k, v in out.items()
                 if k.startswith(prefix + "/fwd/calls/") and int(v)}
        upd = {k.split("/")[-1]: int(v) for k, v in out.items()
               if k.startswith(prefix + "/upd/calls/") and int(v)}
        if n == 1:
            assert calls == upd == {}
        else:
            assert calls == {"all_gather": 2 if weighted else 1,
                             "all_to_all": 1}
            assert upd == {"all_to_all": 1, "all_reduce_sum": 1}
        assert not bool(out.get("jax_imported", False))
    if n == 4:  # ranks 1 and 2 hold no tower
        for r in (1, 2):
            assert not outs[r][f"{prefix}/weights"].any()


@pytest.mark.parametrize("variant,optim", CASES)
def test_towers_at_world_size_4_match_jax(ranks, variant, optim):
    _check(ranks, variant, optim, 4)


@pytest.mark.parametrize("variant,optim", CASES)
def test_towers_at_world_size_1_match_jax(init, variant, optim):
    out = {}
    cases.run_tower_case(ShardingEnv("cpu"), variant, optim, init, out)
    _check([out], variant, optim, 1)


def test_towers_read_their_features_by_key(init):
    """The collection takes its features by key, so a batch whose keys
    come in another order (and carry a feature no tower reads) gives the
    same output; JAX's indexes the batch's feature axis in the towers'
    declaration order and needs the batch in that order."""
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    tc = cases.build_towers(ShardingEnv("cpu"), "plain", "EXACT_SGD")
    cases.load_towers(tc, init, "plain")
    ids, lengths, _ = cases.tower_batch(3, False)
    sb = PaddedSparseBatch(torch.as_tensor(ids), torch.as_tensor(lengths),
                           cases.FEATURES)
    order = [3, 5, 0, 4, 2, 1]
    shuffled = PaddedSparseBatch(
        torch.as_tensor(np.concatenate([ids, ids[:1]])[order]),
        torch.as_tensor(np.concatenate([lengths, lengths[:1]])[order]),
        tuple((cases.FEATURES + ("other",))[i] for i in order))
    with torch.no_grad():
        torch.testing.assert_close(tc(shuffled), tc(sb), rtol=0, atol=0)


def test_tower_errors_match_jax():
    """Mixed embedding dims and a tower outside the world raise, as in
    JAX."""
    from torchrec_tpu_torch.parallel.tower_sharding import TowerSpec

    def spec(dim, device):
        return TowerSpec(tables=(EmbeddingBagConfig(
            num_embeddings=4, embedding_dim=dim, name=f"t{dim}",
            feature_names=[f"f{dim}"]),), interaction=MLP(dim, (2,),
                                                          device="meta"),
            device=device, d_out=2)

    env = ShardingEnv("cpu")
    with pytest.raises(ValueError, match="share embedding_dim"):
        ShardedEmbeddingTowerCollection(env, [spec(4, 0), spec(8, 0)])
    with pytest.raises(ValueError, match="outside mesh"):
        ShardedEmbeddingTowerCollection(env, [spec(4, 1)])


# -- through the DMP ------------------------------------------------------------

B, L, DIM, LR = 16, 2, 8, 0.1
PORT_KEY = "etc"


def _jax_towers():
    return (
        JEmbeddingTower(
            embedding_module=JEBC(tables=(
                JConfig(num_embeddings=50, embedding_dim=DIM, name="a0",
                        feature_names=["fa0"]),
                JConfig(num_embeddings=30, embedding_dim=DIM, name="a1",
                        feature_names=["fa1", "fa2"])), max_feature_length=L),
            interaction_module=JMLP(layer_sizes=(12, 6))),
        JEmbeddingTower(
            embedding_module=JEBC(tables=(
                JConfig(num_embeddings=40, embedding_dim=DIM, name="b0",
                        feature_names=["fb0"]),), max_feature_length=L),
            interaction_module=JMLP(layer_sizes=(10,))),
    )


class JTowerModel(fnn.Module):
    etc: JEmbeddingTowerCollection

    @fnn.compact
    def __call__(self, sb, labels):
        logits = fnn.Dense(1)(self.etc(sb))[:, 0]
        y = labels.astype(logits.dtype)
        loss = jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        return loss, (loss, logits)


class JOneTower(fnn.Module):
    tower: JEmbeddingTower

    @fnn.compact
    def __call__(self, sb, labels):
        logits = fnn.Dense(1)(self.tower(sb))[:, 0]
        loss = jnp.mean((logits - labels.astype(logits.dtype)) ** 2)
        return loss, (loss, logits)


def _towers():
    def ebc(tables):
        return EmbeddingBagCollection(
            [EmbeddingBagConfig(num_embeddings=r, embedding_dim=DIM,
                                name=n, feature_names=list(f))
             for r, n, f in tables], max_feature_length=L, device="meta")

    return [EmbeddingTower(ebc([(50, "a0", ["fa0"]),
                                (30, "a1", ["fa1", "fa2"])]),
                           MLP(3 * DIM, (12, 6), device="meta")),
            EmbeddingTower(ebc([(40, "b0", ["fb0"])]),
                           MLP(DIM, (10,), device="meta"))]


class TowerModel(torch.nn.Module):
    flax_names = {"Dense_0": "head"}

    def __init__(self):
        super().__init__()
        self.etc = EmbeddingTowerCollection(_towers())
        self.head = torch.nn.Linear(16, 1, device="meta")

    def forward(self, sb, labels):
        logits = self.head(self.etc(sb))[:, 0]
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, labels)
        return loss, (loss, logits)


class OneTower(torch.nn.Module):
    flax_names = {"Dense_0": "head"}

    def __init__(self):
        super().__init__()
        self.tower = _towers()[0]
        self.head = torch.nn.Linear(6, 1, device="meta")

    def forward(self, sb, labels):
        logits = self.head(self.tower(sb))[:, 0]
        loss = torch.mean((logits - labels) ** 2)
        return loss, (loss, logits)


FEATS = ("fa0", "fa1", "fa2", "fb0")
FEAT_ROWS = {"fa0": 50, "fa1": 30, "fa2": 30, "fb0": 40}


def _batch(seed=7):
    """test_tower_dmp.py's batch: (values, lengths, labels)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, size=(len(FEATS) * B,)).astype(np.int32)
    values = []
    for fi, f in enumerate(FEATS):
        for b in range(B):
            values.extend(rng.randint(0, FEAT_ROWS[f],
                                      size=(lengths[fi * B + b],)).tolist())
    labels = (rng.rand(B) > 0.5).astype(np.float32)
    return np.asarray(values, np.int32), lengths, labels


def _jbatch(seed=7):
    v, lens, labels = _batch(seed)
    return (JKJT.from_lengths(FEATS, jnp.asarray(v), jnp.asarray(lens))
            .to_padded(L), jnp.asarray(labels))


def _tbatch(seed=7):
    v, lens, labels = _batch(seed)
    return KeyedJaggedTensor.from_lengths(FEATS, v, lens), torch.as_tensor(
        labels)


def _jax_dmp(model, **fused):
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                fused_optim=JOptim.EXACT_SGD,
                fused_params={"learning_rate": LR, **fused},
                dense_optimizer=optax.sgd(LR))


def _port_dmp(model, **fused):
    return DistributedModelParallel(
        model, device="cpu", fused_optim=EmbOptimType.EXACT_SGD,
        fused_params={"learning_rate": LR, **fused},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=LR))


def _bridged(jmodel, model, key, **fused):
    """A JAX DMP and the port's from its initial state."""
    jdmp = _jax_dmp(jmodel, **fused)
    sb, labels = _jbatch()
    state = jdmp.init(jax.random.PRNGKey(1), sb, labels)
    dmp = _port_dmp(model, **fused)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[key].unshard_to_dense(state.emb_states[key]),
        interaction_params={key: [
            jax.tree.map(np.asarray, dict(p))
            for p in state.emb_states[key].interaction_params]})
    return jdmp, state, dmp


def _hold(jdmp, state, dmp, key, rtol=1e-5, atol=1e-6):
    """Tables, interaction parameters and the head against JAX's."""
    jtc = jdmp.sharded_ebcs[key]
    jtables = jtc.unshard_to_dense(state.emb_states[key])
    for name, t in dmp.sharded_ebcs[key].unshard_to_dense().items():
        np.testing.assert_allclose(t, np.asarray(jtables[name]), rtol=rtol,
                                   atol=atol, err_msg=name)
    tc = dmp.sharded_ebcs[key]
    for i, inter in enumerate(tc.interactions):
        want = flax_dense_to_state_dict(jax.tree.map(
            np.asarray, dict(state.emb_states[key].interaction_params[i])),
            inter)
        for name, p in inter.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"tower {i} {name}")
    head = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, dict(state.dense_params)), dmp.module)
    for name, v in head.items():
        np.testing.assert_allclose(
            dmp.module.get_parameter(name).detach().numpy(), v, rtol=rtol,
            atol=atol, err_msg=name)


def test_tower_dmp_golden_step_matches_jax():
    """The DMP plans each tower's tables onto one rank, and its eval
    logits and one SGD step (loss, tables, interaction parameters, head)
    equal the JAX DMP's from the same bridged weights."""
    jdmp, state, dmp = _bridged(
        JTowerModel(etc=JEmbeddingTowerCollection(towers=_jax_towers())),
        TowerModel(), PORT_KEY)
    tc = dmp.sharded_ebcs[PORT_KEY]
    assert isinstance(tc, ShardedEmbeddingTowerCollection)
    ranks = {t.name: tw.device for tw in tc.towers for t in tw.tables}
    assert ranks["a0"] == ranks["a1"]
    assert all(ps.sharding_type is ShardingType.TABLE_WISE
               for ps in dmp.plan.plan[PORT_KEY].values())
    sb, labels = _jbatch()
    _, (_, jlogits) = jdmp.forward(state, sb, labels)
    kjt, tlabels = _tbatch()
    _, (_, logits) = dmp.make_eval_fn()(kjt, tlabels)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    state, jloss, _ = jdmp.make_train_step(donate=False)(state, sb, labels)
    loss, _ = dmp.make_train_step()(kjt, tlabels)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _hold(jdmp, state, dmp, PORT_KEY)


@pytest.mark.parametrize("which", ["collection", "single_tower"])
def test_tower_dmp_trains_as_jax(which):
    """Three steps on alternating batches: losses and the trained state
    equal JAX's (rtol 1e-4 / atol 1e-5), and the loss falls."""
    if which == "collection":
        jmodel = JTowerModel(etc=JEmbeddingTowerCollection(
            towers=_jax_towers()))
        model, key = TowerModel(), PORT_KEY
    else:
        jmodel, model, key = JOneTower(tower=_jax_towers()[0]), OneTower(), \
            "tower"
    jdmp, state, dmp = _bridged(jmodel, model, key)
    jstep, step = jdmp.make_train_step(donate=False), dmp.make_train_step()
    losses = []
    for i in range(3):
        state, jloss, _ = jstep(state, *_jbatch(i % 2))
        loss, _ = step(*_tbatch(i % 2))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    _hold(jdmp, state, dmp, key, rtol=1e-4, atol=1e-5)


def test_interaction_lr_stays_at_the_base_lr_under_a_fused_schedule():
    """Under a fused lr_schedule the tables step at the scheduled lr and
    the interactions at the base `learning_rate`, as the JAX DMP builds
    its collection; the interaction parameters are not the dense
    optimizer's."""
    schedule = lambda step: 0.5 * LR * (step + 1)  # noqa: E731
    jdmp, state, dmp = _bridged(
        JTowerModel(etc=JEmbeddingTowerCollection(towers=_jax_towers())),
        TowerModel(), PORT_KEY, lr_schedule=schedule)
    tc = dmp.sharded_ebcs[PORT_KEY]
    assert tc.interaction_lr == LR
    dense = {id(p) for g in dmp.dense_optimizer.param_groups
             for p in g["params"]}
    assert not dense & {id(p) for p in tc.parameters()}
    assert dense == {id(p) for p in dmp.module.head.parameters()}
    before = [p.detach().clone() for p in tc.interactions.parameters()]
    jstep, step = jdmp.make_train_step(donate=False), dmp.make_train_step()
    for i in range(2):
        state, _, _ = jstep(state, *_jbatch(i % 2))
        step(*_tbatch(i % 2))
    _hold(jdmp, state, dmp, PORT_KEY, rtol=1e-4, atol=1e-5)
    assert any(not torch.equal(a, p) for a, p in
               zip(before, tc.interactions.parameters()))


@pytest.mark.parametrize("case", ["row_wise", "split_tower", "uvm"])
def test_tower_plans_that_are_not_co_located_raise(case):
    """A tower planned other than TABLE_WISE, or split over ranks, raises
    JAX's ValueError. A tower table planned FUSED_UVM_CACHING stays on the
    device, as in JAX, whose tower branch reads only the sharding type and
    the ranks: both DMPs build a tower collection, and the port's run
    equals the FUSED plan's bit for bit."""
    from torchrec_tpu.parallel import ParameterSharding as JPS
    from torchrec_tpu.parallel import ShardingPlan as JPlan
    from torchrec_tpu.parallel import ShardingType as JST
    from torchrec_tpu.parallel.types import ComputeKernel as JCK
    from torchrec_tpu_torch.parallel.types import ComputeKernel

    if case == "uvm":
        def plan(kernel):
            return ShardingPlan({PORT_KEY: {n: ParameterSharding(
                ShardingType.TABLE_WISE, ranks=[0], compute_kernel=kernel)
                for n in ("a0", "a1", "b0")}})

        jdmp = JDMP(
            JTowerModel(etc=JEmbeddingTowerCollection(towers=_jax_towers())),
            env=JEnv.from_devices(jax.devices()[:1]),
            plan=JPlan({PORT_KEY: {n: JPS(JST.TABLE_WISE, ranks=[0],
                                          compute_kernel=JCK.FUSED_UVM_CACHING)
                                   for n in ("a0", "a1", "b0")}}),
            fused_optim=JOptim.EXACT_SGD, fused_params={"learning_rate": LR},
            dense_optimizer=optax.sgd(LR))
        assert jdmp._kinds[PORT_KEY] == "tower" and not jdmp._uvm_split
        state = jdmp.init(jax.random.PRNGKey(1), *_jbatch())
        runs = []
        for kernel in (ComputeKernel.FUSED, ComputeKernel.FUSED_UVM_CACHING):
            dmp = DistributedModelParallel(
                TowerModel(), device="cpu", plan=plan(kernel),
                fused_optim=EmbOptimType.EXACT_SGD,
                fused_params={"learning_rate": LR},
                dense_optimizer=lambda p: torch.optim.SGD(p, lr=LR))
            load_jax_weights(
                dmp, jax.tree.map(np.asarray, state.dense_params),
                jdmp.sharded_ebcs[PORT_KEY].unshard_to_dense(
                    state.emb_states[PORT_KEY]),
                interaction_params={PORT_KEY: [
                    jax.tree.map(np.asarray, dict(p)) for p in
                    state.emb_states[PORT_KEY].interaction_params]})
            assert isinstance(dmp.sharded_ebcs[PORT_KEY],
                              ShardedEmbeddingTowerCollection)
            step = dmp.make_train_step()
            losses = [float(step(*_tbatch(i))[0]) for i in range(2)]
            runs.append((losses, dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()))
        jstep = jdmp.make_train_step(donate=False)
        for i in range(2):
            state, _, _ = jstep(state, *_jbatch(i))
        _hold(jdmp, state, dmp, PORT_KEY)
        assert runs[0][0] == runs[1][0]
        for name, t in runs[0][1].items():
            np.testing.assert_array_equal(runs[1][1][name], t)
        return
    if case == "row_wise":
        plan = {n: ParameterSharding(ShardingType.ROW_WISE)
                for n in ("a0", "a1", "b0")}
        match = "must be TABLE_WISE"
    else:
        plan = {"a0": ParameterSharding(ShardingType.TABLE_WISE, ranks=[0]),
                "a1": ParameterSharding(ShardingType.TABLE_WISE, ranks=[1]),
                "b0": ParameterSharding(ShardingType.TABLE_WISE, ranks=[0])}
        match = "multiple ranks"
    env = ShardingEnv("cpu")
    env.world_size = 2
    with pytest.raises(ValueError, match=match):
        DistributedModelParallel(TowerModel(), env=env,
                                 plan=ShardingPlan({PORT_KEY: plan}))
