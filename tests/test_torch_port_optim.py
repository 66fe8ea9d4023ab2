"""The port's optimizer stack (torchrec_tpu_torch/optim) against the JAX
package's and optax, on the CPU.

Inputs are made from a seed with numpy. A small module of flax-style
Dense layers stands for the dense parameters: its flax tree goes to the
port through utils/jax_bridge.py, optax states through
`optax_state_to_keyed`, and both sides take the same gradients (the flax
kernels' transposed for the port's weights).

Tolerances: FQN keys, the bridge's round trips, value clipping and the
warmup schedule are exact (the schedule bit for bit in float32 on every
policy; the golden trace of tests/test_warmup_parity.py at its own rtol
1e-6 / atol 1e-7). Norm clipping is bit for bit where both sides sum the
squares in one order (one gradient), and rtol 1e-6 otherwise. Optimizer
steps hold to rtol 1e-5 (atol 1e-7), as
test_torch_adam_matches_optax_adam does: torch and optax round the Adam
update, and the warmup's lr scaling against optax's scaling of the update,
in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_warmup_parity import CONFIGS, _ref_lr_trace
from torchrec_tpu.optim import GradientClipping as JClipping
from torchrec_tpu.optim import KeyedOptimizer as JKeyedOptimizer
from torchrec_tpu.optim import WarmupPolicy as JPolicy
from torchrec_tpu.optim import WarmupStage as JStage
from torchrec_tpu.optim import gradient_clipping as jgradient_clipping
from torchrec_tpu.optim import make_warmup_schedule as jmake_warmup_schedule
from torchrec_tpu.optim import warmup_optimizer as jwarmup_optimizer
from torchrec_tpu.optim.keyed import flatten_with_fqns as jflatten
from torchrec_tpu.optim.keyed import unflatten_from_fqns as junflatten
from torchrec_tpu_torch.modules.dense import Dense
from torchrec_tpu_torch.optim import (
    GradientClipping,
    GradientClippingOptimizer,
    KeyedOptimizer,
    KeyedOptimizerWrapper,
    WarmupOptimizer,
    WarmupPolicy,
    WarmupStage,
    flatten_with_fqns,
    gradient_clipping,
    make_warmup_schedule,
    unflatten_from_fqns,
    warmup_optimizer,
)
from torchrec_tpu_torch.optim.warmup import WARMUP_KEY
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    keyed_to_optax_state,
    load_flax_params,
    optax_state_to_keyed,
)

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
STAGES = [(JPolicy.LINEAR, 8, 0.1), (JPolicy.CONSTANT, 100, 0.5)]


def _stages(port=True):
    if port:
        return [WarmupStage(WarmupPolicy[p.name], m, v) for p, m, v in STAGES]
    return [JStage(p, m, v) for p, m, v in STAGES]


def _port_stages(jstages):
    return [WarmupStage(WarmupPolicy[s.policy.name], s.max_iters, s.value,
                        s.lr_scale, s.decay_iters) for s in jstages]


# -- FQN flattening ----------------------------------------------------------

TREES = {
    "nested_dict": lambda a: {"m": {"dense_arch": {"Dense_0": {
        "kernel": a(3, 2), "bias": a(2)}}, "over": {"w": a(4)}}},
    "lists_and_tuples": lambda a: {"a": [a(2), (a(1), {"z": a(3)})],
                                   "b": (a(2), [])},
    "none_leaves": lambda a: {"a": None, "b": {"c": a(2), "d": None}},
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_flatten_keys_equal_jax(tree):
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    np_tree = TREES[tree](arr)
    jflat = jflatten(jax.tree.map(jnp.asarray, np_tree))
    flat = flatten_with_fqns(jax.tree.map(torch.as_tensor, np_tree))
    # the same keys (JAX lists a dict's keys sorted, the port in order)
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(jflat[k]))
    back = unflatten_from_fqns(np_tree, flat)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    assert all(torch.equal(a, torch.as_tensor(b)) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(np_tree)))


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_unflatten_is_strict_as_jax(fault):
    tree = {"mlp": {"w": np.ones((3, 2)), "b": np.zeros(2)}}
    for flatten, unflatten in ((jflatten, junflatten),
                               (flatten_with_fqns, unflatten_from_fqns)):
        flat = flatten(tree)
        if fault == "missing":
            del flat["mlp/b"]
        else:
            flat["mlp/extra"] = np.zeros(())
        with pytest.raises(KeyError, match=fault):
            unflatten(tree, flat)
    # not strict: the template fills a missing leaf
    flat = flatten_with_fqns(tree)
    del flat["mlp/b"]
    assert unflatten_from_fqns(tree, flat, strict=False)["mlp"]["b"] is (
        tree["mlp"]["b"])


# -- a small dense model on both sides ---------------------------------------


class _Net(nn.Module):
    """Two flax-style Dense layers, the second without a bias; its flax
    tree is {"layer": {"kernel", "bias"}, "head": {"kernel"}}."""

    def __init__(self):
        super().__init__()
        self.layer = Dense(5, 3, "cpu")
        self.head = Dense(3, 2, "cpu", bias=False)


def _flax_params(seed):
    rng = np.random.RandomState(seed)
    return {"layer": {"kernel": rng.randn(5, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)},
            "head": {"kernel": rng.randn(3, 2).astype(np.float32)}}


def _grads(seed, scale=1.0):
    return jax.tree.map(lambda x: (x * scale).astype(np.float32),
                        _flax_params(seed))


def _port(params):
    net = _Net()
    load_flax_params(net, params)
    return net


def _set_grads(net, grads):
    for name, g in flax_dense_to_state_dict(grads, net).items():
        net.get_parameter(name).grad = torch.as_tensor(g).clone()


def _assert_params(net, jparams, **tol):
    want = flax_dense_to_state_dict(jax.tree.map(np.asarray, jparams), net)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **tol)


def _seeded(tree, seed):
    """Moments in [0, 0.01) from a seed, in a tree's shapes."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(0.01 * rng.rand(*np.shape(x)).astype(
            np.float32)), tree)


def _mid_run(state, seed, count=5):
    """An optax state part way through a run: every Adam and momentum
    moment seeded, every count at `count`."""
    def fix(node):
        kind = type(node).__name__
        if kind == "ScaleByAdamState":
            return node._replace(count=jnp.int32(count),
                                 mu=_seeded(node.mu, seed),
                                 nu=_seeded(node.nu, seed + 1))
        if kind == "TraceState":
            return node._replace(trace=_seeded(node.trace, seed))
        if kind == "ScaleByScheduleState":
            return node._replace(count=jnp.int32(count))
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(fix(c) for c in node)
        return node
    return fix(state)


def _run_both(tx, factory, steps, seed=0, start_count=None):
    """`steps` updates of the optax transform and the port's optimizer
    from the same params and (with start_count) the same mid-run state.
    Returns (jax params, jax state, port net, port optimizer)."""
    jparams = jax.tree.map(jnp.asarray, _flax_params(seed))
    jstate = tx.init(jparams)
    if start_count is not None:
        jstate = _mid_run(jstate, seed + 10, start_count)
    net = _port(jax.tree.map(np.asarray, jparams))
    opt = factory(list(net.parameters()))
    keyed = KeyedOptimizer(opt, dict(net.named_parameters()))
    keyed.load_state_dict(optax_state_to_keyed(
        jax.tree.map(np.asarray, jstate), net))
    for s in range(steps):
        g = _grads(100 + seed + s)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_grads(net, g)
        opt.step()
    return jparams, jstate, net, opt


# -- KeyedOptimizer ----------------------------------------------------------


@pytest.mark.parametrize("make", ["sgd", "sgd_momentum", "adam", "adamw"])
def test_keyed_optimizer_round_trip(make):
    factory = {
        "sgd": lambda p: torch.optim.SGD(p, lr=0.1),
        "sgd_momentum": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
        "adam": lambda p: torch.optim.Adam(p, lr=1e-3),
        "adamw": lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=0.1),
    }[make]
    net = _port(_flax_params(0))
    keyed = KeyedOptimizerWrapper(dict(net.named_parameters()), factory)
    names = {"sgd": (), "sgd_momentum": ("momentum_buffer",),
             "adam": ("step", "exp_avg", "exp_avg_sq"),
             "adamw": ("step", "exp_avg", "exp_avg_sq")}[make]
    # materialised before the first step, as optax's init materialises
    fresh = keyed.state_dict()
    assert sorted(fresh) == sorted(f"{n}/{s}" for n, _ in
                                   net.named_parameters() for s in names)
    assert all(not t.any() for t in fresh.values())
    for s in range(2):
        _set_grads(net, _grads(s))
        keyed.step()
    sd = {k: v.clone() for k, v in keyed.state_dict().items()}
    other = _port(_flax_params(0))
    okeyed = KeyedOptimizerWrapper(dict(other.named_parameters()), factory)
    okeyed.load_state_dict(sd)
    assert okeyed.state_dict().keys() == sd.keys()
    for k, v in okeyed.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the loaded optimizer steps as the one it was taken from
    with torch.no_grad():
        for p, q in zip(other.parameters(), net.parameters()):
            p.copy_(q)
    for n in (net, other):
        _set_grads(n, _grads(7))
    keyed.step()
    okeyed.step()
    for p, q in zip(net.parameters(), other.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_keyed_optimizer_load_is_strict(fault):
    net = _port(_flax_params(0))
    keyed = KeyedOptimizerWrapper(dict(net.named_parameters()),
                                  lambda p: torch.optim.Adam(p, lr=1e-3))
    sd = dict(keyed.state_dict())
    before = {k: v.clone() for k, v in sd.items()}
    if fault == "missing":
        del sd["layer.bias/exp_avg"]
    else:
        sd["layer.bias/extra"] = torch.zeros(3)
    sd = {k: v + 1 for k, v in sd.items()}
    with pytest.raises(KeyError, match=fault):
        keyed.load_state_dict(sd)
    for k, v in keyed.state_dict().items():  # nothing was copied
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError, match="exactly"):
        KeyedOptimizer(keyed.optimizer, {"layer.weight": net.layer.weight})


@pytest.mark.parametrize("kind,steps", [("sgd", 3), ("sgd_momentum", 3),
                                        ("adam", 1), ("adam", 3)])
def test_steps_match_optax_from_bridged_state(kind, steps):
    tx, factory = {
        "sgd": (optax.sgd(0.05), lambda p: torch.optim.SGD(p, lr=0.05)),
        "sgd_momentum": (optax.sgd(0.05, momentum=0.9),
                         lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9)),
        "adam": (optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3)),
    }[kind]
    jparams, jstate, net, opt = _run_both(tx, factory, steps, seed=1,
                                          start_count=5)
    _assert_params(net, jparams, **STEP_TOL)
    keyed = KeyedOptimizer(opt, dict(net.named_parameters()))
    back = keyed_to_optax_state(keyed.state_dict(), net,
                                jax.tree.map(np.asarray, jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b), **STEP_TOL)


@pytest.mark.parametrize("chain", ["warmup_clip_adam", "sgd_momentum"])
def test_bridge_round_trips_optax_state(chain):
    if chain == "warmup_clip_adam":
        tx = jwarmup_optimizer(jgradient_clipping(
            optax.adam(1e-3), JClipping.NORM, 1.0), _stages(False), 0.1)
        factory = warmup_optimizer(gradient_clipping(
            lambda p: torch.optim.Adam(p, lr=1e-3), GradientClipping.NORM,
            1.0), _stages(), 0.1)
    else:
        tx = optax.sgd(0.1, momentum=0.9)
        factory = lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9)  # noqa
    params = _flax_params(2)
    jstate = jax.tree.map(np.asarray, _mid_run(
        tx.init(jax.tree.map(jnp.asarray, params)), 3, count=5))
    net = _port(params)
    keyed = KeyedOptimizerWrapper(dict(net.named_parameters()), factory)
    flat = optax_state_to_keyed(jstate, net)
    keyed.load_state_dict(flat)
    got = keyed.state_dict()
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = keyed_to_optax_state(got, net, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, b)
    if chain == "warmup_clip_adam":
        assert int(got[f"{WARMUP_KEY}/count"]) == 5
        assert float(got["layer.weight/step"]) == 5.0
        # the kernel moments take the port's [out, in] layout
        np.testing.assert_array_equal(
            got["layer.weight/exp_avg"].numpy(),
            jstate[0][1][0].mu["layer"]["kernel"].T)
        assert keyed.optimizer.count == 5


def test_bridge_refuses_an_unknown_optax_state():
    net = _port(_flax_params(0))
    state = optax.adagrad(0.1).init(jax.tree.map(jnp.asarray,
                                                 _flax_params(0)))
    with pytest.raises(ValueError, match="no port counterpart"):
        optax_state_to_keyed(jax.tree.map(np.asarray, state), net)


# -- warmup ------------------------------------------------------------------

POLICIES = {
    **CONFIGS,
    "none_then_linear": [JStage(JPolicy.NONE, max_iters=3),
                         JStage(JPolicy.LINEAR, max_iters=9, value=0.2,
                                lr_scale=0.7)],
    "invsqrt_from_zero": [JStage(JPolicy.INVSQRT, max_iters=12)],
    "step_scaled": [JStage(JPolicy.STEP, max_iters=20, value=0.3,
                           lr_scale=1.7, decay_iters=3)],
    "the_smoke_stages": _stages(False),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_warmup_schedule_equals_jax_bit_for_bit(name):
    stages = POLICIES[name]
    n = 3 * max(s.max_iters for s in stages) + 1
    for base_lr in (0.34, 0.1, 1.0):
        jsched = jmake_warmup_schedule(stages, base_lr)
        sched = make_warmup_schedule(_port_stages(stages), base_lr)
        want = np.array([np.asarray(jsched(k)) for k in range(n)])
        got = np.array([sched(k) for k in range(n)], np.float32)
        assert want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {base_lr}")
        # every value is a float holding a float32
        assert all(type(sched(k)) is float and
                   np.float32(sched(k)) == sched(k) for k in range(n))
    # a 0-d tensor count, as the optimizer keeps it, reads the same
    assert sched(torch.tensor(n - 1, dtype=torch.int32)) == sched(n - 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warmup_schedule_matches_golden_trace(name):
    stages = CONFIGS[name]
    n = max(s.max_iters for s in stages) + 10
    want = _ref_lr_trace(stages, 0.34, n)
    sched = make_warmup_schedule(_port_stages(stages), base_lr=0.34)
    np.testing.assert_allclose([sched(k) for k in range(n)], want,
                               rtol=1e-6, atol=1e-7, err_msg=name)


def test_warmup_stage_order_validation():
    with pytest.raises(ValueError, match="must exceed"):
        make_warmup_schedule([WarmupStage(WarmupPolicy.LINEAR, max_iters=10),
                              WarmupStage(WarmupPolicy.CONSTANT, max_iters=5)])


@pytest.mark.parametrize("inner", ["sgd", "sgd_momentum_wd", "adam", "adamw"])
def test_warmup_optimizer_matches_optax_chain(inner):
    jinner, factory = {
        "sgd": (optax.sgd(0.05), lambda p: torch.optim.SGD(p, lr=0.05)),
        "sgd_momentum_wd": (
            optax.chain(optax.add_decayed_weights(0.01),
                        optax.sgd(0.05, momentum=0.9)),
            lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9,
                                      weight_decay=0.01)),
        "adam": (optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3)),
        "adamw": (optax.adamw(1e-3, weight_decay=0.1),
                  lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=0.1)),
    }[inner]
    tx = jwarmup_optimizer(jinner, _stages(False), base_lr=0.5)
    jparams, jstate, net, opt = _run_both(
        tx, warmup_optimizer(factory, _stages(), base_lr=0.5), steps=12,
        seed=3)
    assert isinstance(opt, WarmupOptimizer) and opt.count == 12
    assert int(jstate[-1].count) == 12
    _assert_params(net, jparams, **STEP_TOL)
    # the groups' lr is the inner one again after every step
    assert {g["lr"] for g in opt.param_groups} == {
        0.05 if inner.startswith("sgd") else 1e-3}


def test_warmup_count_lives_in_the_optimizer_state():
    net = _port(_flax_params(0))
    opt = warmup_optimizer(lambda p: torch.optim.Adam(p, lr=1e-3),
                           _stages())(list(net.parameters()))
    for s in range(3):
        _set_grads(net, _grads(s))
        opt.step()
    assert opt.count == 3 and opt.state is opt.inner.state
    assert int(opt.state[WARMUP_KEY]["count"]) == 3
    # torch's state_dict carries it; a load restores it and keeps sharing
    sd = opt.state_dict()
    opt.state.clear()  # what the DMP's init does
    assert opt.count == 0
    assert float(opt.inner.state[net.layer.weight]["step"]) == 0.0
    opt.load_state_dict(sd)
    assert opt.count == 3 and opt.state is opt.inner.state
    assert opt.param_groups is opt.inner.param_groups
    assert float(opt.state[net.layer.weight]["step"]) == 3.0


@pytest.mark.parametrize("bad", ["adagrad", "tensor_lr"])
def test_warmup_refuses_optimizers_it_cannot_scale(bad):
    net = _port(_flax_params(0))
    params = list(net.parameters())
    inner = (torch.optim.Adagrad(params, lr=0.1) if bad == "adagrad"
             else torch.optim.Adam(params, lr=torch.tensor(1e-3)))
    with pytest.raises(NotImplementedError):
        WarmupOptimizer(inner, _stages())


# -- clipping ----------------------------------------------------------------


def _clip_case(case):
    """(flax grads, max_norm): the global norm below, exactly at or above
    max_norm. At the boundary the grads are (3, 4, 12) * 2^-3 in the first
    layer and zeros elsewhere, whose norm 13/8 is exact in float32."""
    g = _grads(4)
    norm = float(np.sqrt(sum(np.sum(np.square(x))
                             for x in jax.tree.leaves(g))))
    if case == "below":
        return g, norm * 1.5
    if case == "above":
        return g, norm / 3.0
    g = jax.tree.map(np.zeros_like, g)
    g["layer"]["bias"] = np.array([3.0, 4.0, 12.0], np.float32) / 8
    return g, 13.0 / 8


@pytest.mark.parametrize("case", ["below", "at", "above"])
def test_norm_clipping_follows_optax(case):
    grads, max_norm = _clip_case(case)
    clip = optax.clip_by_global_norm(max_norm)
    jg = jax.tree.map(jnp.asarray, grads)
    want, _ = clip.update(jg, clip.init(jg))
    net = _port(_flax_params(0))
    opt = GradientClippingOptimizer(torch.optim.SGD(net.parameters(), lr=1.0),
                                    GradientClipping.NORM, max_norm)
    _set_grads(net, grads)
    opt.clip_()
    got = {n: p.grad.numpy() for n, p in net.named_parameters()}
    ref = flax_dense_to_state_dict(jax.tree.map(np.asarray, want), net)
    for name in got:
        if case == "at":  # one nonzero gradient: one summation order
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-6,
                                       atol=0, err_msg=name)
    g0 = np.asarray(grads["layer"]["bias"])
    if case == "below":
        np.testing.assert_array_equal(got["layer.bias"], g0)
    elif case == "at":
        # g_norm == max_norm is not below it: optax divides and multiplies
        f32 = np.float32
        np.testing.assert_array_equal(
            got["layer.bias"], (g0 / f32(13.0 / 8)) * f32(13.0 / 8))
        assert float(opt.last_norm) == 13.0 / 8
    else:
        norm = np.sqrt(sum(np.sum(np.square(v)) for v in got.values()))
        np.testing.assert_allclose(norm, max_norm, rtol=1e-6)


def test_value_clipping_follows_optax():
    grads = _grads(5, scale=2.0)
    jg = jax.tree.map(jnp.asarray, grads)
    want, _ = optax.clip(0.5).update(jg, optax.clip(0.5).init(jg))
    net = _port(_flax_params(0))
    opt = gradient_clipping(lambda p: torch.optim.SGD(p, lr=1.0),
                            GradientClipping.VALUE, 0.5)(
                                list(net.parameters()))
    _set_grads(net, grads)
    opt.clip_()
    ref = flax_dense_to_state_dict(jax.tree.map(np.asarray, want), net)
    for name, p in net.named_parameters():
        np.testing.assert_array_equal(p.grad.numpy(), ref[name])
    assert any((np.abs(v) > 0.5).any() for v in jax.tree.leaves(grads))


@pytest.mark.parametrize("clipping", ["NORM", "VALUE", "NONE"])
def test_warmup_of_clipped_adam_matches_optax(clipping):
    """The chip phase's dense optimizer at small size, 12 steps from a
    mid-warmup Adam state; the norm clip engages on every step."""
    jtx = jwarmup_optimizer(jgradient_clipping(
        optax.adam(1e-3), JClipping[clipping], 0.5), _stages(False))
    factory = warmup_optimizer(gradient_clipping(
        lambda p: torch.optim.Adam(p, lr=1e-3), GradientClipping[clipping],
        0.5), _stages())
    jparams, jstate, net, opt = _run_both(jtx, factory, steps=12, seed=6,
                                          start_count=5)
    _assert_params(net, jparams, **STEP_TOL)
    assert opt.count == 17 and int(jstate[-1].count) == 17
    if clipping == "NONE":
        assert isinstance(opt.inner, torch.optim.Adam)
    else:
        assert isinstance(opt.inner, GradientClippingOptimizer)
    if clipping == "NORM":
        assert float(opt.inner.last_norm) > 0.5


def test_keyed_state_dict_of_the_jax_chain_has_the_same_leaves():
    """The JAX KeyedOptimizer keys its leaves by optax chain position and
    flax path; the port by parameter FQN and torch state name. The bridge
    maps one onto the other, leaf for leaf."""
    params = jax.tree.map(jnp.asarray, _flax_params(0))
    jtx = jwarmup_optimizer(jgradient_clipping(
        optax.adam(1e-3), JClipping.NORM, 1.0), _stages(False))
    jko = JKeyedOptimizer(jtx)
    jsd = jko.state_dict(jko.init(params))
    net = _port(_flax_params(0))
    factory = warmup_optimizer(gradient_clipping(
        lambda p: torch.optim.Adam(p, lr=1e-3), GradientClipping.NORM, 1.0),
        _stages())
    keyed = KeyedOptimizerWrapper(dict(net.named_parameters()), factory)
    sd = keyed.state_dict()
    # JAX: adam's count, mu and nu per leaf and the schedule's count
    assert sorted(jsd) == sorted(
        ["0/1/0/.count", "1/.count"]
        + [f"0/1/0/.{m}/{p}" for m in ("mu", "nu")
           for p in ("head/kernel", "layer/bias", "layer/kernel")])
    assert sorted(sd) == sorted(
        [f"{WARMUP_KEY}/count"]
        + [f"{p}/{s}" for s in ("step", "exp_avg", "exp_avg_sq")
           for p in ("head.weight", "layer.bias", "layer.weight")])
    assert sum(v.size for v in jsd.values()) == sum(
        v.numel() for k, v in sd.items() if not k.endswith("/step")) + 1
