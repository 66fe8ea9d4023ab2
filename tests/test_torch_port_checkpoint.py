"""The port's checkpoints (utils/checkpoint.py) and its JAX-shaped state
dict, on the CPU.

- tests/test_momentum_reshard.py's cases on gloo ranks
  (tests/torch_port_uvm_cases.py, "reshard"): a source DMP on two ranks
  trained 2 steps and saved by `save_reshardable`, loaded into the source
  plan (the control) and into the destination plan, one step each. RW2 ->
  TW4 and TW2 -> RW4 (JAX's TW2 -> RW8 on four ranks) under
  ROWWISE_ADAGRAD and RW2 -> CW4 under ADAM give the control's tables
  within rtol 1e-6; a CW2 checkpoint loads into RW4 as the mean of its
  column shards' rowwise momenta; an RW2 one into CW2 replicates the
  rowwise momentum into each shard with a warning; CW2 -> TWCW (local
  size 2, two column shards) moves the shards' momenta exactly; a
  ROWWISE_ADAGRAD checkpoint loaded under ADAM restarts the momenta fresh
  with a warning. The weights reshard exactly in every case.
- `unsharded_state_dict` at world size 2 gathers one table at a time: the
  largest all_gather is one table's span of the blocks, not the layout,
  and the tables and optimizer state equal those of the whole layout's
  gather bit for bit.
- test_advice_fixes_r2.py's UVM round trip (mixed and all-UVM plans) and
  test_uvm_cache.py's Adam npz (`.m2`, an integer `.step`): the resumed
  step equals the uninterrupted one bit for bit.
- A `.npz` that JAX's `save_reshardable` wrote (a ROW_WISE DLRM, and the
  mixed UVM model) loads through `load_jax_reshardable`; 2 more steps
  equal JAX's 2 more steps.
- A UVM table's momentum follows it onto the device: JAX's
  `load_reshardable` feeds `uvmopt/` to UVM modules only, so the mixed
  model's checkpoint loaded into an all-device plan restarts the whole
  group's momenta at zero (pinned here); the port's load carries them.
- `save_state` / `restore_state` (test_end_to_end_learning.py's exact
  resume, here with an Adam dense optimizer, a UVM table and a fused
  ROWWISE_ADAGRAD): the resumed run equals the uninterrupted one bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_uvm_cases as cases
from test_torch_port_uvm import _JModel, _jargs, _jax_init
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.utils.checkpoint import (
    load_reshardable as jload_reshardable,
)
from torchrec_tpu.utils.checkpoint import (
    save_reshardable as jsave_reshardable,
)
from torchrec_tpu_torch.parallel import ShardingEnv
from torchrec_tpu_torch.utils.checkpoint import (
    load_reshardable,
    restore_state,
    save_reshardable,
    save_state,
)
from torchrec_tpu_torch.utils.jax_bridge import (
    fused_optimizer_state,
    load_jax_reshardable,
)

KEY = cases.RS_KEY


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.spawn("reshard", 4, tmp_path_factory.mktemp("reshard"))


def _tables(out, prefix, what):
    return {t: out[f"{prefix}/{what}/{t}"] for t in ("t0", "t1")}


@pytest.mark.parametrize("case", list(cases.RESHARD))
def test_reshard_across_plans(ranks, case):
    assert not any(bool(o["jax_imported"]) for o in ranks)
    out, prefix = ranks[0], f"reshard/{case}"
    saved, loaded = _tables(out, prefix, "saved"), _tables(out, prefix,
                                                           "loaded")
    for t in saved:  # weights reshard exactly under any plan
        np.testing.assert_array_equal(loaded[t], saved[t])
    warned = " ".join(str(w) for w in out[prefix + "/warnings"])
    if case in ("rw2_tw4", "tw2_rw4", "rw2_cw4_adam"):
        control, got = (_tables(out, prefix, "control"),
                        _tables(out, prefix, "reshard"))
        for t in control:  # the dense gradients' mean over 2 or 4 ranks
            np.testing.assert_allclose(got[t], control[t], rtol=1e-6,
                                       atol=1e-7, err_msg=t)
        assert not warned
    for t in ("t0", "t1"):
        src = f"{prefix}/saved_opt/{t}/"
        dst = f"{prefix}/loaded_opt/{t}/"
        if case == "cw2_rw4":
            assert out[src + "m1__cwrow"].shape == (2, cases.RS_ROWS)
            np.testing.assert_allclose(out[dst + "m1__row"],
                                       out[src + "m1__cwrow"].mean(axis=0),
                                       rtol=1e-6)
        elif case == "rw2_cw2":
            assert "not recoverable" in warned
            for s in range(2):
                np.testing.assert_array_equal(out[dst + "m1__cwrow"][s],
                                              out[src + "m1__row"])
        elif case == "cw2_twcw4":
            np.testing.assert_array_equal(out[dst + "m1__cwrow"],
                                          out[src + "m1__cwrow"])
        elif case == "kind_rw2_rw4":
            assert "restarts fresh" in warned
            assert not out[dst + "m1__full"].any()
            assert not out[dst + "m2__full"].any()
        elif case == "rw2_cw4_adam":
            for tag in ("m1__full", "m2__full"):
                np.testing.assert_array_equal(out[dst + tag], out[src + tag])
        else:
            np.testing.assert_array_equal(out[dst + "m1__row"],
                                          out[src + "m1__row"])
        if case != "kind_rw2_rw4":
            assert int(out[dst + "step"]) == 2


@pytest.mark.parametrize("st", cases.GATHER_TYPES)
def test_unsharded_state_dict_gathers_one_table_at_a_time(ranks, st):
    out, prefix = ranks[0], f"gather/{st}"
    one_table = 2 * cases.RS_ROWS * cases.RS_D
    assert int(out[prefix + "/largest"]) <= one_table
    assert int(out[prefix + "/largest"]) < int(out[prefix + "/layout"])
    # the whole-layout gather the rank made before, bit for bit
    for k, v in out.items():
        if k.startswith(prefix + "/layout_gather/"):
            np.testing.assert_array_equal(
                out[k.replace("/layout_gather/", "/")], v, err_msg=k)
    assert sum(k.startswith(prefix + "/layout_gather/") for k in out) == 6
    assert ranks[1][prefix + "/largest"] == out[prefix + "/largest"]


@pytest.mark.parametrize("all_uvm", [False, True])
def test_uvm_reshardable_round_trip(tmp_path, all_uvm):
    env = ShardingEnv("cpu")
    dmp = cases.uvm_dmp(env, all_uvm, "ROWWISE_ADAGRAD").init(1)
    step = dmp.make_train_step()
    for i in range(2):
        step(*cases.port_args(i))
    path = str(tmp_path / "ck.npz")
    save_reshardable(path, dmp)
    with np.load(path) as data:
        keys = set(data.files)
    assert "tables/ebc/t1" in keys and "uvmopt/ebc/t1" in keys
    assert ("opt/ebc/t0/m1__row" in keys) != all_uvm
    step(*cases.port_args(9))
    want = dmp.unsharded_state_dict()
    dmp2 = cases.uvm_dmp(env, all_uvm, "ROWWISE_ADAGRAD").init(33)
    load_reshardable(path, dmp2)
    dmp2.make_train_step()(*cases.port_args(9))
    got = dmp2.unsharded_state_dict()
    for name in ("t0", "t1"):
        np.testing.assert_array_equal(got["embeddings/ebc"][name],
                                      want["embeddings/ebc"][name])


def test_uvm_adam_npz_keeps_the_integer_step(tmp_path):
    env = ShardingEnv("cpu")
    dmp = cases.uvm_dmp(env, True, "ADAM").init(0)
    step = dmp.make_train_step()
    for i in range(3):
        step(*cases.port_args(i))
    path = str(tmp_path / "uvm_adam.npz")
    save_reshardable(path, dmp)
    with np.load(path) as data:
        assert {"uvmopt/ebc/t0", "uvmopt/ebc/t0.m2",
                "uvmopt/ebc/t0.step"} <= set(data.files)
        assert np.issubdtype(data["uvmopt/ebc/t0.step"].dtype, np.integer)
    for i in range(3, 5):
        step(*cases.port_args(i))
    golden = dmp.unsharded_state_dict()["embeddings/ebc"]["t0"]
    dmp2 = cases.uvm_dmp(env, True, "ADAM").init(7)
    load_reshardable(path, dmp2)
    step2 = dmp2.make_train_step()
    for i in range(3, 5):
        step2(*cases.port_args(i))
    np.testing.assert_array_equal(
        dmp2.unsharded_state_dict()["embeddings/ebc"]["t0"], golden)


def _jax_rs_dmp():
    tables = tuple(JConfig(num_embeddings=cases.RS_ROWS,
                           embedding_dim=cases.RS_D, name=f"t{i}",
                           feature_names=[f"f{i}"]) for i in range(2))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=1),
        dense_in_features=4, dense_arch_layer_sizes=(8, cases.RS_D),
        over_arch_layer_sizes=(8, 1)))
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({"dlrm/embedding_bag_collection": {
                    f"t{i}": JPS(JST.ROW_WISE) for i in range(2)}}),
                fused_optim=JOptim.ROWWISE_ADAGRAD,
                fused_params={"learning_rate": 0.1},
                dense_optimizer=optax.sgd(0.1))


def _jax_rs_args(seed):
    dense, sb, labels = cases.rs_args(seed)
    return (jnp.asarray(dense.numpy()),
            JKJT.from_lengths(["f0", "f1"],
                              jnp.asarray(sb.ids.numpy().reshape(-1)),
                              jnp.ones(2 * cases.RS_B, jnp.int32)
                              ).to_padded(1),
            jnp.asarray(labels.numpy()))


def test_jax_reshardable_checkpoint_resumes_in_the_port(tmp_path):
    """A ROW_WISE DLRM saved by JAX after 2 steps, loaded into the port
    under TABLE_WISE; 2 more steps on both sides: losses rtol 1e-5, tables
    and rowwise momenta rtol 1e-5."""
    jdmp = _jax_rs_dmp()
    state = jdmp.init(jax.random.PRNGKey(0), *_jax_rs_args(0))
    jstep = jdmp.make_train_step(donate=False)
    for i in range(2):
        state, _, _ = jstep(state, *_jax_rs_args(i))
    path = str(tmp_path / "jax.npz")
    jsave_reshardable(path, jdmp, state)
    dmp = cases.rs_dmp(ShardingEnv("cpu"), "TABLE_WISE", "ROWWISE_ADAGRAD")
    load_jax_reshardable(path, dmp.init(3))
    assert dmp.step == 2
    step = dmp.make_train_step()
    for i in range(2, 4):
        state, jloss, _ = jstep(state, *_jax_rs_args(i))
        loss, _ = step(*cases.rs_args(i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    (jsebc,) = [jdmp.sharded_ebcs["dlrm/embedding_bag_collection"]]
    jtables = jsebc.unshard_to_dense(
        state.emb_states["dlrm/embedding_bag_collection"])
    got = dmp.unsharded_state_dict()[f"embeddings/{KEY}"]
    jopt = {}
    for strat, g in zip(jsebc.strategies,
                        state.emb_states["dlrm/embedding_bag_collection"]):
        jopt.update(strat.unshard_opt_to_tables(g.opt))
    opt = fused_optimizer_state(dmp)
    for t in ("t0", "t1"):
        np.testing.assert_allclose(got[t], np.asarray(jtables[t]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(opt[t]["m1__row"], jopt[t]["m1__row"],
                                   rtol=1e-5, atol=1e-9)
        assert int(opt[t]["step"]) == int(jopt[t]["step"]) == 4


def test_jax_uvm_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's mixed UVM model after 2 steps, saved with its UVM table and
    momentum (`uvmopt/ebc/t1`), loaded into the port's mixed DMP; 2 more
    steps equal JAX's (tables, UVM momentum, losses)."""
    jdmp, state = _jax_init(False, "ROWWISE_ADAGRAD")
    jstep = jdmp.make_train_step(donate=False)
    for i in range(2):
        state, _, _ = jstep(state, *_jargs(i))
    path = str(tmp_path / "jax_uvm.npz")
    jsave_reshardable(path, jdmp, state)
    dmp = cases.uvm_dmp(ShardingEnv("cpu"), False, "ROWWISE_ADAGRAD")
    load_jax_reshardable(path, dmp.init(9))
    step = dmp.make_train_step()
    for i in range(2, 4):
        state, jloss, _ = jstep(state, *_jargs(i))
        loss, _ = step(*cases.port_args(i))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = jdmp.state_dict(state)
    got = dmp.unsharded_state_dict()
    for name in ("t0", "t1"):
        np.testing.assert_allclose(got["embeddings/ebc"][name],
                                   want["embeddings/ebc"][name], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got["uvm_momentum/ebc"]["t1"],
                               want["uvm_momentum/ebc"]["t1"], rtol=1e-5,
                               atol=1e-9)


def test_save_state_restore_state_resumes_bit_for_bit(tmp_path):
    env = ShardingEnv("cpu")

    def make():
        dmp = cases.uvm_dmp(env, False, "ROWWISE_ADAGRAD")
        dmp.dense_optimizer = torch.optim.Adam(dmp._dense_parameters(),
                                               lr=1e-2)
        return dmp

    dmp = make().init(0)
    step = dmp.make_train_step()
    for i in range(3):
        step(*cases.port_args(i))
    path = str(tmp_path / "state.pt")
    save_state(path, dmp)
    golden = [float(step(*cases.port_args(i))[0]) for i in range(3, 5)]
    want = dmp.unsharded_state_dict()
    dmp2 = make().init(11)
    restore_state(path, dmp2)
    assert dmp2.step == 3
    step2 = dmp2.make_train_step()
    assert [float(step2(*cases.port_args(i))[0])
            for i in range(3, 5)] == golden
    got = dmp2.unsharded_state_dict()
    for n, t in want["dense"].items():
        assert torch.equal(got["dense"][n], t), n
    for name in ("t0", "t1"):
        np.testing.assert_array_equal(got["embeddings/ebc"][name],
                                      want["embeddings/ebc"][name])
    np.testing.assert_array_equal(got["uvm_momentum/ebc"]["t1"],
                                  want["uvm_momentum/ebc"]["t1"])
    assert dmp2.cache_stats()["ebc"]["t1"]["misses"] > 0


def test_uvm_momenta_follow_a_table_onto_the_device(tmp_path):
    jdmp, state = _jax_init(False, "ROWWISE_ADAGRAD")
    jstep = jdmp.make_train_step(donate=False)
    for i in range(2):
        state, _, _ = jstep(state, *_jargs(i))
    path = str(tmp_path / "mixed.npz")
    jsave_reshardable(path, jdmp, state)
    saved = jdmp.state_dict(state)["uvm_momentum/ebc"]
    saved_t0 = {}
    for strat, g in zip(jdmp.sharded_ebcs["ebc"].strategies,
                        state.emb_states["ebc"]):
        saved_t0.update(strat.unshard_opt_to_tables(g.opt))
    # JAX: the device group restarts (t1 has no opt/ entry)
    tables = tuple(JConfig(num_embeddings=r, embedding_dim=cases.UVM_D,
                           name=f"t{i}", feature_names=[f"f{i}"])
                   for i, r in enumerate(cases.UVM_ROWS))
    jdev = JDMP(_JModel.make(tables), env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({"ebc": {t.name: JPS(JST.ROW_WISE)
                                    for t in tables}}),
                fused_optim=JOptim.ROWWISE_ADAGRAD,
                fused_params={"learning_rate": cases.UVM_FUSED_LR},
                dense_optimizer=optax.sgd(cases.UVM_DENSE_LR))
    js = jload_reshardable(path, jdev,
                           jdev.init(jax.random.PRNGKey(3), *_jargs(0)))
    jopt = {}
    for strat, g in zip(jdev.sharded_ebcs["ebc"].strategies,
                        js.emb_states["ebc"]):
        jopt.update(strat.unshard_opt_to_tables(g.opt))
    assert not jopt["t0"]["m1__row"].any() and not jopt["t1"]["m1__row"].any()
    # the port: both momenta carried onto the device
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    dmp = DistributedModelParallel(
        cases.UvmModel(cases.uvm_tables()), device="cpu",
        plan=ShardingPlan({"ebc": {f"t{i}": ParameterSharding(
            ShardingType.ROW_WISE) for i in range(2)}}),
        fused_optim=EmbOptimType.ROWWISE_ADAGRAD,
        fused_params={"learning_rate": cases.UVM_FUSED_LR}).init(3)
    load_jax_reshardable(path, dmp)
    opt = fused_optimizer_state(dmp)
    np.testing.assert_array_equal(opt["t1"]["m1__row"], saved["t1"])
    np.testing.assert_array_equal(opt["t0"]["m1__row"],
                                  saved_t0["t0"]["m1__row"])
    assert int(opt["t0"]["step"]) == 2
