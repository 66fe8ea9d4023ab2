"""The port's DLRM_DCN and its jagged multi-hot route, on the CPU.

`models.DLRM_DCN` against the plain reference in tests/dcn_reference.py
(no JAX, no port) on seeded weights at a tiny size: logits, loss and every
gradient, unsharded; then three train steps of the DMP (fused ADAGRAD on
the tables, torch.optim.Adagrad on the dense layers) against the
reference's three steps, fed KeyedJaggedTensors, with no batch padded on
the way. The DATA_PARALLEL strategy's jagged route (K1j and the update
over the real values) against its padded route (bit for bit) and against
the JAX strategy on the same ids, with bags of length 0, a MEAN feature,
per-sample weights, bags cut at the EBC's max_feature_length and a
KeyedJaggedTensor with slack past its real values. `LowRankCrossNet`
against JAX's on bridged weights, and K1j's plain version against K1's
plain version and against float64 sums. The kernel itself is held on the
card in test_torch_port_dcn_card.py.

Tolerances, each for its reason:
  * logits and loss rtol 1e-5 / atol 1e-6: the same f32 products, summed
    in another order (the port's fused addmm and K1's pooling against the
    reference's matmul, bias add and index_add);
  * gradients rtol 1e-4 / atol 1e-6: each is a sum over the batch's
    examples of such products, in another order again; the flax-drawn
    cross net's, whose sums cancel more, within 1e-5 of each gradient's
    largest element;
  * three DMP steps rtol 1e-4 / atol 1e-5 on the losses, the dense
    parameters, the tables and the Adagrad sums, as test_torch_port_train
    holds the DLRM's steps; the steps are Adagrad's first, whose update
    lr g / (|g| + eps) does not grow the gradients' rounding;
  * the jagged route against the padded route: bit for bit (the same
    coefficients, the same slots in the same order);
  * both routes against JAX: the pooled sums rtol 1e-6 / atol 1e-7 and
    the updated rows and state at test_torch_port_strategies.py's
    tolerances (the XLA sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dcn_reference as ref
from torchrec_tpu.modules import crossnet as jcross
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JBagConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import (
    embedding_names_by_table as j_names_by_table,
)
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import fused_state_shapes
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.embedding_sharding import (
    group_tables as j_group_tables,
)
from torchrec_tpu.parallel.strategies import EmbeddingGroupState as JState
from torchrec_tpu.parallel.strategies import (
    create_sharding_strategy as j_create,
)
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.models import DLRM_DCN, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    LowRankCrossNet,
)
from torchrec_tpu_torch.modules.embedding_configs import PoolingType
from torchrec_tpu_torch.modules.embedding_modules import (
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import DistributedModelParallel, ShardingEnv
from torchrec_tpu_torch.parallel.embedding_sharding import group_tables
from torchrec_tpu_torch.parallel.strategies import create_sharding_strategy
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    load_flax_params,
)

# the model: four tables at D = 8, dense 5 -> 16 -> 8, two cross layers
# of rank 4 over (4 + 1) * 8 = 40, over 40 -> 16 -> 8 -> 1
ROWS = (30, 50, 20, 40)
KEYS = tuple(f"f{i}" for i in range(len(ROWS)))
D, DENSE_IN, B, MAX_L = 8, 5, 16, 5
DENSE_LAYERS, OVER_LAYERS = (16, D), (16, 8, 1)
CROSS_LAYERS, RANK = 2, 4
LR, EPS = 0.05, 1e-8
LOGITS = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-4, atol=1e-5)


def _params(seed: int) -> ref.Params:
    """Seeded weights: tables U(-0.5, 0.5), layers U(+-1/sqrt(fan_in)),
    the cross layers' b as drawn (not zero), so every term shows."""
    g = torch.Generator().manual_seed(seed)

    def u(shape, bound):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    def layers(sizes, fan_in):
        out = []
        for fo in sizes:
            out.append((u((fo, fan_in), fan_in ** -0.5),
                        u((fo,), fan_in ** -0.5)))
            fan_in = fo
        return out

    N = (len(ROWS) + 1) * D
    return ref.Params(
        tables=[u((r, D), 0.5) for r in ROWS],
        dense=layers(DENSE_LAYERS, DENSE_IN),
        cross=[(u((RANK, N), N ** -0.5), u((N, RANK), RANK ** -0.5),
                u((N,), 0.1)) for _ in range(CROSS_LAYERS)],
        over=layers(OVER_LAYERS, N))


def _batch(seed: int, batch: int = B):
    """(dense, values, lengths, labels): each bag 0..MAX_L ids."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, MAX_L + 1, (len(ROWS) * batch,),
                            generator=g, dtype=torch.int32)
    per = lengths.reshape(len(ROWS), batch).sum(dim=1)
    values = torch.cat([torch.randint(0, r, (int(n),), generator=g,
                                      dtype=torch.int32)
                        for r, n in zip(ROWS, per)])
    dense = torch.randn(batch, DENSE_IN, generator=g)
    labels = torch.randint(0, 2, (batch,), generator=g).float()
    return dense, values, lengths, labels


def _kjt(values, lengths):
    return KeyedJaggedTensor.from_lengths(KEYS, values, lengths)


def _tables():
    return [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                               name=f"t{i}", feature_names=[k])
            for i, (r, k) in enumerate(zip(ROWS, KEYS))]


def _model(device):
    ebc = EmbeddingBagCollection(_tables(), max_feature_length=MAX_L,
                                 device=device)
    return DLRM_DCN(ebc, DENSE_IN, DENSE_LAYERS, OVER_LAYERS, CROSS_LAYERS,
                    RANK, device=device)


def _dense_params(m: DLRM_DCN):
    """The port's dense parameters in `ref.Params.dense_tensors`' order."""
    out = []
    for p in m.dense_arch.mlp.perceptrons:
        out += [p.linear.weight, p.linear.bias]
    cn = m.inter_arch.crossnet
    for v, w in zip(cn.V, cn.W):
        assert v.bias is None
        out += [v.weight, w.weight, w.bias]
    for p in [*m.over_arch.mlp.perceptrons, m.over_arch.head]:
        out += [p.linear.weight, p.linear.bias]
    return out


@torch.no_grad()
def _load_dense(m: DLRM_DCN, p: ref.Params) -> None:
    for t, r in zip(_dense_params(m), p.dense_tensors()):
        assert t.shape == r.shape
        t.copy_(r)


def test_dlrm_dcn_matches_the_reference():
    """Logits, loss and every gradient of the unsharded model."""
    p = _params(0)
    dense, values, lengths, labels = _batch(1)
    model = _model("cpu")
    _load_dense(model, p)
    with torch.no_grad():
        for i, t in enumerate(p.tables):
            model.sparse_arch.embedding_bag_collection.embedding_bags[
                f"t{i}"].copy_(t)
    train = DLRMTrain(model)
    loss, (_, logits, _) = train(dense, _kjt(values, lengths), labels)
    loss.backward()
    want = ref.gradients(p, dense, values, lengths, labels)
    torch.testing.assert_close(logits.detach(), want.logits, **LOGITS)
    torch.testing.assert_close(loss.detach(), want.loss, **LOGITS)
    for i, (t, g) in enumerate(zip(_dense_params(model), want.dense_grads)):
        torch.testing.assert_close(t.grad, g, **GRADS, msg=f"dense {i}")
    bags = model.sparse_arch.embedding_bag_collection.embedding_bags
    for i, g in enumerate(want.table_grads):
        torch.testing.assert_close(bags[f"t{i}"].grad, g, **GRADS,
                                   msg=f"table {i}")


def _dmp():
    dmp = DistributedModelParallel(
        DLRMTrain(_model("meta")), fused_optim=EmbOptimType.ADAGRAD,
        fused_params={"learning_rate": LR, "eps": EPS},
        dense_optimizer=lambda ps: torch.optim.Adagrad(ps, lr=LR, eps=EPS),
        device="cpu")
    return dmp


def test_dmp_adagrad_steps_match_the_reference(monkeypatch):
    """Three DMP steps on KeyedJaggedTensors against the reference's
    three: the losses, then the dense parameters, every table row and the
    tables' Adagrad sums. No batch is padded on the way: the sharded EBC
    takes the jagged route."""
    p = _params(2)
    dmp = _dmp()
    (key,) = dmp.sharded_ebcs
    dmp.load_tables({key: {f"t{i}": t.clone()
                           for i, t in enumerate(p.tables)}})
    _load_dense(dmp.module.dlrm, p)

    def refuse(*_a, **_k):
        raise AssertionError("a jagged batch was padded")

    monkeypatch.setattr(KeyedJaggedTensor, "to_padded", refuse)
    step = dmp.make_train_step()
    state = ref.State.zeros(p)
    for s in range(3):
        dense, values, lengths, labels = _batch(10 + s)
        loss, _ = step(dense, _kjt(values, lengths), labels)
        want = ref.train_step(p, state, dense, values, lengths, labels,
                              LR, EPS, LR, EPS)
        torch.testing.assert_close(loss, want.loss, **STEPS,
                                   msg=f"loss {s}")
    for i, (t, r) in enumerate(zip(_dense_params(dmp.module.dlrm),
                                   p.dense_tensors())):
        torch.testing.assert_close(t.detach(), r, **STEPS, msg=f"dense {i}")
    sebc = dmp.sharded_ebcs[key]
    tables = sebc.unshard_tables()
    opt = sebc.unshard_opt_to_tables()
    for i, (t, m) in enumerate(zip(p.tables, state.tables)):
        torch.testing.assert_close(tables[f"t{i}"], t, **STEPS,
                                   msg=f"table {i}")
        torch.testing.assert_close(torch.as_tensor(opt[f"t{i}"]["m1__full"]),
                                   m, **STEPS, msg=f"momentum {i}")
        assert int(opt[f"t{i}"]["step"]) == 3


def test_dmp_step_builds_the_jagged_route_once(monkeypatch):
    """A step's forward and update share one route a group: three steps
    on three batches build three, and a forward on a batch the sharded EBC
    has not seen builds a new one."""
    from torchrec_tpu_torch.parallel.strategies import DpEmbeddingSharding

    built = []
    route = DpEmbeddingSharding.jagged_route

    def counted(self, kjt, max_length):
        built.append(kjt)
        return route(self, kjt, max_length)

    monkeypatch.setattr(DpEmbeddingSharding, "jagged_route", counted)
    dmp = _dmp()
    (key,) = dmp.sharded_ebcs
    assert len(dmp.sharded_ebcs[key].strategies) == 1
    step = dmp.make_train_step()
    batches = [_batch(20 + s) for s in range(3)]
    for dense, values, lengths, labels in batches:
        step(dense, _kjt(values, lengths), labels)
    assert len(built) == 3
    dense, values, lengths, labels = batches[0]
    dmp.make_eval_fn()(dense, _kjt(values, lengths), labels)
    assert len(built) == 4


# -- the jagged route against the padded route and JAX ----------------------

S_ROWS = (50, 131, 77)
S_KEYS = tuple(f"g{i}" for i in range(len(S_ROWS)))
S_B, S_L = 8, 6
S_TOL = {"EXACT_SGD": (1e-5, 1e-6), "ROWWISE_ADAGRAD": (1e-5, 1e-6),
         "ADAGRAD": (1e-5, 1e-6), "ADAM": (1e-4, 1e-6)}


def _s_configs():
    """(JAX configs, port configs): three tables at D = 8, the second MEAN."""
    return [[Cfg(num_embeddings=r, embedding_dim=D, name=f"s{i}",
                 feature_names=[S_KEYS[i]],
                 pooling=Pool.MEAN if i == 1 else Pool.SUM)
             for i, r in enumerate(S_ROWS)]
            for Cfg, Pool in ((JBagConfig, JPooling),
                              (EmbeddingBagConfig, PoolingType))]


def _s_state(optim, seed=0):
    rng = np.random.RandomState(seed)
    dense = {f"s{i}": (rng.randn(r, D) * 0.1).astype(np.float32)
             for i, r in enumerate(S_ROWS)}
    opt = {}
    for i, r in enumerate(S_ROWS):
        entry = {"step": np.asarray(2, np.int32)}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(JOptim[optim])):
            shape = {"row": (r,), "full": (r, D)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        opt[f"s{i}"] = entry
    return dense, opt


def _s_strategy(optim, weighted, dense, opt):
    cfg = _s_configs()[1]
    (meta,) = group_tables(cfg, embedding_names_by_table(cfg),
                           {c.name: ParameterSharding(
                               ShardingType.DATA_PARALLEL) for c in cfg},
                           weighted)
    strat = create_sharding_strategy(ShardingEnv("cpu"), meta,
                                     EmbOptimType[optim], {})
    strat.weights = strat.shard_from_dense(dense)
    strat.shard_opt_from_tables(opt)
    return strat


def _s_jax(optim, weighted, dense, opt):
    jcfg = _s_configs()[0]
    (jmeta,) = j_group_tables(jcfg, j_names_by_table(jcfg),
                              {c.name: JPS(JST.DATA_PARALLEL) for c in jcfg},
                              weighted)
    jstrat = j_create(JEnv.from_devices(jax.devices()[:1]), jmeta,
                      JOptim[optim], {})
    state = JState(weights=jstrat.shard_from_dense(dense),
                   opt=jstrat.shard_opt_from_tables(opt, jstrat.init_opt()))
    return jstrat, state


def _s_batch(seed, weighted, slack):
    """A jagged batch with bags of 0..S_L + 2 ids (cut at S_L by the
    route), per-sample weights where `weighted`, and `slack` values past
    the real ones (a KeyedJaggedTensor of a static size)."""
    rng = np.random.RandomState(seed)
    F = len(S_ROWS)
    lengths = rng.randint(0, S_L + 3, size=F * S_B).astype(np.int32)
    lengths[:3] = 0  # empty bags, the MEAN feature's among them below
    lengths[S_B:S_B + 2] = 0
    per = lengths.reshape(F, S_B).sum(axis=1)
    values = np.concatenate([rng.randint(0, r, size=n)
                             for r, n in zip(S_ROWS, per)]).astype(np.int32)
    values = np.concatenate([values, rng.randint(0, 50, size=slack).astype(
        np.int32)])
    w = (rng.rand(values.shape[0]).astype(np.float32) + 0.5
         if weighted else None)
    return KeyedJaggedTensor.from_lengths(
        S_KEYS, torch.as_tensor(values), torch.as_tensor(lengths),
        weights=None if w is None else torch.as_tensor(w))


def _padded(kjt):
    return kjt.to_padded(S_L)


def _jsb(sb: PaddedSparseBatch):
    return JPSB(ids=jnp.asarray(sb.ids.numpy()),
                lengths=jnp.asarray(sb.lengths.numpy()), keys=sb.keys,
                weights=None if sb.weights is None
                else jnp.asarray(sb.weights.numpy()))


@pytest.mark.parametrize("slack", [0, 9])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("optim", sorted(S_TOL))
def test_jagged_route_matches_padded_and_jax(optim, weighted, slack):
    dense, opt = _s_state(optim)
    jagged = _s_strategy(optim, weighted, dense, opt)
    padded = _s_strategy(optim, weighted, dense, opt)
    kjt = _s_batch(3, weighted, slack)
    sb = _padded(kjt)
    route = jagged.jagged_route(kjt, S_L)
    out = jagged.forward_jagged(route)
    assert torch.equal(out, padded(sb))
    jstrat, state = _s_jax(optim, weighted, dense, opt)
    jout = jax.jit(jstrat.forward)(state, _jsb(sb))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)
    d = torch.as_tensor(np.random.RandomState(4).randn(
        len(S_ROWS), S_B, D).astype(np.float32))
    jagged.update_jagged(route, d, 0.1)
    padded.update(sb, d, 0.1)
    state = jax.jit(jstrat.update)(state, _jsb(sb), jnp.asarray(d.numpy()),
                                   0.1)
    rtol, atol = S_TOL[optim]
    for name in ("weights", "momentum1", "momentum2"):
        a, b = getattr(jagged, name), getattr(padded, name)
        if a is None:
            continue
        assert torch.equal(a, b), name
        j = state.weights if name == "weights" else getattr(state.opt, name)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert int(jagged.step) == int(state.opt.step) == 3


class _Shapes(TorchDispatchMode):
    """Every tensor shape an operation produces."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _segment_sum_lookup(weights, ids, offsets, coeff=None, cap=tl.NO_CAP):
    """K1j without a padded layout, as the kernel reads it: each real id's
    row times its coefficient, summed into its bag."""
    lengths = (offsets[1:] - offsets[:-1]).clamp(max=cap)
    pos = torch.arange(ids.shape[0], dtype=torch.int32)
    bag = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(
        0, lengths.shape[0] - 1)
    real = (pos < offsets[-1]) & (pos - offsets[bag] < cap)
    c = real.float() if coeff is None else torch.where(real, coeff, 0.0)
    rows = weights[ids.long().clamp(0, weights.shape[0] - 1)].float()
    out = torch.zeros(lengths.shape[0], weights.shape[1])
    return out.index_add_(0, bag, rows * c[:, None])


def test_jagged_route_builds_no_padded_tensor(monkeypatch):
    """The jagged forward and update make no [F, B, L] ids and no
    [F, B, L, D] gradient: no tensor of theirs has an axis of S_L slots
    or F B S_L elements in a row (the padded route's do). K1j's plain
    version pads its bags to sum as K1's plain version does, so here it
    is a segment sum over the real ids, as the kernel reads them."""
    monkeypatch.setattr(tl, "tbe_lookup_jagged_reference",
                        _segment_sum_lookup)
    dense, opt = _s_state("ADAGRAD")
    kjt = _s_batch(5, True, 0)
    N = kjt.values.shape[0]
    F = len(S_ROWS)
    assert S_L not in (N, F, S_B, D) and F * S_B * S_L != N

    def shapes(run):
        strat = _s_strategy("ADAGRAD", True, dense, opt)
        d = torch.ones(F, S_B, D)
        with _Shapes() as rec:
            run(strat, d)
        return rec.shapes

    def padded_axes(shapes):
        return [s for s in shapes if S_L in s or F * S_B * S_L in s]

    def jagged_step(s, d):
        route = s.jagged_route(kjt, S_L)
        return s.forward_jagged(route), s.update_jagged(route, d, 0.1)

    jagged = shapes(jagged_step)
    assert jagged and padded_axes(jagged) == []
    assert max(int(np.prod(s)) for s in jagged) <= max(
        N * D, sum(S_ROWS) * D + 128 * D)
    padded = shapes(lambda s, d: (s(_padded(kjt)),
                                  s.update(_padded(kjt), d, 0.1)))
    assert padded_axes(padded)


# -- LowRankCrossNet and K1j's plain version ---------------------------------


def test_lowrank_crossnet_matches_jax():
    """The cross net at the DCN's layout (N = (F+1) D, bias-less V) on
    the flax module's own weights, bridged: output and every gradient."""
    N, layers, rank = 5 * D, 3, 4
    jmod = jcross.LowRankCrossNet(num_layers=layers, low_rank=rank)
    x = np.random.RandomState(6).randn(7, N).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"]

    def f(p, x):
        return jmod.apply({"params": p}, x)

    jout, vjp = jax.vjp(f, params, jnp.asarray(x))
    cot = np.random.RandomState(8).randn(*jout.shape).astype(np.float32)
    jdp, jdx = vjp(jnp.asarray(cot))
    mod = LowRankCrossNet(N, layers, rank, "cpu")
    load_flax_params(mod, jax.tree.map(np.asarray, params))
    assert all(v.bias is None for v in mod.V)
    tx = torch.tensor(x, requires_grad=True)
    out = mod(tx)
    out.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **LOGITS)
    want = flax_dense_to_state_dict(jax.tree.map(np.asarray, jdp), mod)
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:  # within 1e-5 of each gradient's scale
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)
    jdx = np.asarray(jdx)
    np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=1e-4,
                               atol=1e-5 * np.abs(jdx).max())


def _jagged_case(seed, R, NB, max_len, dtype=torch.float32, slack=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, max_len + 1, (NB,), generator=g,
                            dtype=torch.int32)
    lengths[::5] = 0
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32),
                         lengths.cumsum(0).to(torch.int32)])
    N = int(offsets[-1]) + slack
    ids = torch.randint(-3, R + 3, (N,), generator=g, dtype=torch.int32)
    coeff = torch.rand(N, generator=g) + 0.25
    w = torch.randn(R, D, generator=g).to(dtype)
    return w, ids, offsets, coeff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [tl.NO_CAP, 3])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_k1_offsets_form_plain_version(dtype, cap, with_coeff):
    """K1j's plain version against K1's plain version on the same bags
    padded (bit for bit) and against float64 sums bag by bag; ids out of
    range clamped, empty bags zero, a bag cut at `cap`, slack ids read by
    no bag."""
    w, ids, offsets, coeff = _jagged_case(9, 37, 41, 7, dtype, slack=5)
    if dtype is not torch.float32:  # as `pooled_lookup` rounds them
        coeff = coeff.to(dtype).float()
    c = coeff if with_coeff else None
    out = tl.tbe_lookup_jagged_forward(w, ids, offsets, c, cap)
    assert out.dtype == torch.float32 and out.shape == (41, D)
    lengths = (offsets[1:] - offsets[:-1]).clamp(max=cap)
    L = int(lengths.max())
    col = torch.arange(L)
    real = col[None, :] < lengths[:, None]
    src = (offsets[:-1, None].long() + col).clamp(max=ids.shape[0] - 1)
    flat = torch.where(real, ids[src], 0).to(torch.int32)
    cf = torch.where(real, coeff[src] if with_coeff else 1.0, 0.0)
    assert torch.equal(out, tl.tbe_lookup_pooled_reference(w, flat, cf))
    w64 = w.double()
    for b in range(41):
        lo = int(offsets[b])
        n = int(lengths[b])
        rows = ids[lo:lo + n].long().clamp(0, 36)
        cb = coeff[lo:lo + n].double() if with_coeff else torch.ones(n)
        want = (w64[rows] * cb[:, None].double()).sum(0)
        torch.testing.assert_close(out[b].double(), want, rtol=1e-6,
                                   atol=1e-6)


def test_k1_offsets_form_checks_its_inputs():
    w, ids, offsets, coeff = _jagged_case(10, 20, 6, 3)
    with pytest.raises(TypeError):
        tl.tbe_lookup_jagged_forward(w, ids.long(), offsets)
    with pytest.raises(TypeError):
        tl.tbe_lookup_jagged_forward(w, ids, offsets.long())
    with pytest.raises(TypeError):
        tl.tbe_lookup_jagged_forward(w, ids, offsets, coeff[:-1])
    with pytest.raises(ValueError):
        tl.tbe_lookup_jagged_forward(w, ids, offsets[:0])
    empty = tl.tbe_lookup_jagged_forward(w, ids[:0], torch.zeros(
        4, dtype=torch.int32))
    assert torch.equal(empty, torch.zeros(3, D))


def test_row_wise_shares_add_up_to_the_whole_table():
    """The cut the MLPerf DLRM-DCNv2 cell runs: one of 8 GPUs' row-wise
    share of each table. Each share pools the ids that fall in its
    ceil(R / 8) rows (the others get a coefficient of 0); the 8 shares'
    partial sums add up to the whole table's pooling, within the f32
    rounding of a sum in another order."""
    R, n = 37, 8
    w, ids, offsets, _ = _jagged_case(11, R, 29, 9)
    ids = ids.clamp(0, R - 1)
    whole = tl.tbe_lookup_jagged_forward(w, ids, offsets)
    rows = -(-R // n)
    parts = torch.zeros_like(whole)
    for s in range(n):
        lo = s * rows
        mine = ((ids >= lo) & (ids < lo + rows)).float()
        share = w[lo:lo + rows].contiguous()
        local = (ids - lo).clamp(0, share.shape[0] - 1).to(torch.int32)
        parts += tl.tbe_lookup_jagged_forward(share, local, offsets, mine)
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
