"""The port's sharding planner (torchrec_tpu_torch/planner/) against the
JAX package's, on the CPU.

Every case of tests/test_planner.py runs on both planners with the JAX
planner's accelerator numbers handed to the port's Topology: its device
spec and its `ops/cost_model` functions and kernel fractions (the test may
import them; the port holds none of them). Plans must be equal (sharding
type, kernel, ranks, host) and each shard's `perf` and `storage` equal to
the last bit, since the port keeps the algorithm and the order of its
float operations. Also: the tower dependency tags against JAX's
enumerator, both PlannerError fallbacks of the DMP's default plan,
`_plan_quant_ranks` at world size 2 and 4, and the card's own defaults:
bench.py's tables plan at world size 1, 2, 4 and 8 (local size 8), each
plan builds a port DMP on `meta`, and a DMP given no plan holds the plan
the planner gives.
"""

import types

import numpy as np
import pytest
import torch

from torchrec_tpu.inference.modules import _plan_quant_ranks as j_quant_ranks
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.ops import cost_model as jcm
from torchrec_tpu.parallel.dmp import _default_plan as j_default_plan
from torchrec_tpu.parallel.sharders import (
    EmbeddingBagCollectionSharder as JEbcSharder,
)
from torchrec_tpu.parallel.sharders import (
    EmbeddingTowerCollectionSharder as JTowerSharder,
)
from torchrec_tpu.parallel.types import ComputeKernel as JKernel
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.planner import EmbeddingShardingPlanner as JPlanner
from torchrec_tpu.planner import ParameterConstraints as JConstraints
from torchrec_tpu.planner import PlannerError as JPlannerError
from torchrec_tpu.planner import Topology as JTopology
from torchrec_tpu.planner import constants as JC
from torchrec_tpu.planner.enumerators import EmbeddingEnumerator as JEnum
from torchrec_tpu.planner.estimators import (
    EmbeddingPerfEstimator as JPerfEst,
)
from torchrec_tpu.planner.estimators import (
    EmbeddingStorageEstimator as JStorageEst,
)
from torchrec_tpu.planner.partitioners import (
    GreedyPerfPartitioner as JPartitioner,
)
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import EmbeddingBagCollection
from torchrec_tpu_torch.modules import EmbeddingBagConfig
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ShardedEmbeddingBagCollection,
    ShardingEnv,
)
from torchrec_tpu_torch.parallel.dmp import _default_plan
from torchrec_tpu_torch.parallel.sharders import (
    EmbeddingBagCollectionSharder,
    EmbeddingTowerCollectionSharder,
)
from torchrec_tpu_torch.parallel.types import ComputeKernel, ShardingType
from torchrec_tpu_torch.planner import (
    CostModel,
    DeviceSpec,
    EmbeddingShardingPlanner,
    ParameterConstraints,
    PlannerError,
    Topology,
)
from torchrec_tpu_torch.planner import constants as C
from torchrec_tpu_torch.planner.enumerators import EmbeddingEnumerator
from torchrec_tpu_torch.planner.estimators import (
    EmbeddingPerfEstimator,
    EmbeddingStorageEstimator,
)
from torchrec_tpu_torch.planner.partitioners import GreedyPerfPartitioner
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

# the JAX planner's v5e numbers, as they enter its arithmetic: the spec's
# rates in units of 2**30 bytes/s, and its host-memory rate as the bare
# number it uses (see ROADMAP.md section 3)
_CAP, _HBM, _ICI, _DCN = JC.TPU_SPECS["v5e"]
JAX_DEVICE = DeviceSpec(name="v5e", hbm_cap=_CAP, hbm_bw=_HBM * 1024**3,
                        intra_bw=_ICI * 1024**3, inter_bw=_DCN * 1024**3,
                        host_bw=JC.DDR_MEM_BW, ddr_cap=JC.HOST_DDR_CAP)
JAX_COSTS = CostModel(lookup_s=jcm.fused_lookup_s,
                      update_s=jcm.fused_update_s,
                      fused_bw_fraction=JC.FUSED_KERNEL_BW_FRACTION,
                      dense_bw_fraction=JC.DENSE_KERNEL_BW_FRACTION,
                      quant_bw_fraction=JC.QUANT_KERNEL_BW_FRACTION)

JT = {st: JST[st.name] for st in ShardingType}
JK = {k: JKernel[k.name] for k in ComputeKernel}


def _topos(world_size, **kw):
    """(the port's Topology with JAX's numbers, JAX's v5e Topology)."""
    return (Topology(world_size, device=JAX_DEVICE, cost_model=JAX_COSTS,
                     **kw),
            JTopology(world_size=world_size, tpu_gen="v5e", **kw))


def _cfgs(specs):
    """(port configs, JAX configs) of (rows, dim, name, features)."""
    return ([EmbeddingBagConfig(num_embeddings=r, embedding_dim=d, name=n,
                                feature_names=list(f)) for r, d, n, f in specs],
            [JConfig(num_embeddings=r, embedding_dim=d, name=n,
                     feature_names=list(f)) for r, d, n, f in specs])


TABLES = [(1_000_000, 128, "big", ["f_big"]), (10_000, 64, "mid", ["f_mid"]),
          (100, 16, "small", ["f_small"])]


def _constraints(c):
    """(port, JAX) ParameterConstraints of {name: kwargs}, sharding types
    by name."""
    def port(kw):
        kw = dict(kw)
        if "sharding_types" in kw:
            kw["sharding_types"] = [ShardingType[s]
                                    for s in kw["sharding_types"]]
        return ParameterConstraints(**kw)

    def jax(kw):
        kw = dict(kw)
        if "sharding_types" in kw:
            kw["sharding_types"] = [JST[s] for s in kw["sharding_types"]]
        return JConstraints(**kw)

    c = c or {}
    return ({k: port(v) for k, v in c.items()},
            {k: jax(v) for k, v in c.items()})


def _same_options(port, jax):
    """Options equal field for field, shards' perf and storage bit for
    bit."""
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert (p.name, JT[p.sharding_type], JK[p.compute_kernel], p.host,
                p.dependency) == (j.name, j.sharding_type, j.compute_kernel,
                                  j.host, j.dependency)
        assert len(p.shards) == len(j.shards)
        for ps, js in zip(p.shards, j.shards):
            assert (ps.size, ps.offset, ps.rank) == (js.size, js.offset,
                                                     js.rank)
            assert ps.perf == js.perf, (p.name, ps.perf, js.perf)
            assert (ps.storage.hbm, ps.storage.ddr) == (js.storage.hbm,
                                                        js.storage.ddr)


def _same_plan(port_plan, jax_plan, path):
    p, j = port_plan.plan[path], jax_plan.plan[path]
    assert list(p) == list(j)
    for name in p:
        assert (JT[p[name].sharding_type], JK[p[name].compute_kernel],
                p[name].ranks, p[name].host) == (
            j[name].sharding_type, j[name].compute_kernel, j[name].ranks,
            j[name].host), name


def _plan_both(world_size, specs, constraints=None, path="m", **kw):
    """Both planners on the same tables: (port plan, JAX plan, port
    planner, JAX planner's best options), the JAX planner's best options
    taken where it turns them into its ShardingPlan."""
    ptopo, jtopo = _topos(world_size, **kw)
    pc, jc = _constraints(constraints)
    pt, jt = _cfgs(specs)
    pp = EmbeddingShardingPlanner(ptopo, constraints=pc)
    jp = JPlanner(jtopo, constraints=jc)
    best = {}
    to_plan = jp._to_sharding_plan

    def capture(plan, module_path):
        best["options"] = plan
        return to_plan(plan, module_path)

    jp._to_sharding_plan = capture
    port_plan, jax_plan = pp.plan(pt, module_path=path), \
        jp.plan(jt, module_path=path)
    _same_plan(port_plan, jax_plan, path)
    _same_options(pp.last_plan, best["options"])
    return port_plan, jax_plan, pp


def _enum_both(world_size, specs, types_=None, **kw):
    ptopo, jtopo = _topos(world_size, **kw)
    pt, jt = _cfgs(specs)
    port = EmbeddingEnumerator(
        ptopo, sharding_types=None if types_ is None
        else [ShardingType[s] for s in types_]).enumerate(pt, None)
    jax = JEnum(jtopo, sharding_types=None if types_ is None
                else [JST[s] for s in types_]).enumerate(jt, None)
    for opts, topo, perf, storage in ((port, ptopo, EmbeddingPerfEstimator,
                                       EmbeddingStorageEstimator),
                                      (jax, jtopo, JPerfEst, JStorageEst)):
        for o in opts:
            perf(topo).estimate(o)
            storage(topo).estimate(o)
    _same_options(port, jax)
    return port, jax, ptopo, jtopo


def test_enumerator_rw_shard_geometry():
    port, _, _, _ = _enum_both(4, [(10, 16, "t", ["f"])], ["ROW_WISE"])
    assert len(port) == 1 and port[0].compute_kernel is ComputeKernel.FUSED
    assert [s.size for s in port[0].shards] == [(3, 16)] * 3 + [(1, 16)]
    assert [s.offset for s in port[0].shards] == [(0, 0), (3, 0), (6, 0),
                                                  (9, 0)]


def test_enumerator_cw_feasibility():
    ok, _, _, _ = _enum_both(4, [(10, 128, "a", ["f"])], ["COLUMN_WISE"])
    assert [s.size for s in ok[0].shards] == [(10, 32)] * 4
    bad, _, _, _ = _enum_both(4, [(10, 64, "b", ["f"])], ["COLUMN_WISE"])
    assert bad == []


def test_estimators_fill_perf_and_storage():
    port, _, _, _ = _enum_both(8, TABLES)
    assert port
    assert all(s.perf > 0 and s.storage.hbm > 0
               for o in port for s in o.shards)


def test_partitioner_tw_balances_load():
    specs = [(1000, 64, f"t{i}", [f"f{i}"]) for i in range(4)]
    port, jax, ptopo, jtopo = _enum_both(2, specs, ["TABLE_WISE"])
    pplan = GreedyPerfPartitioner().partition(port, ptopo)
    jplan = JPartitioner().partition(jax, jtopo)
    _same_options(pplan, jplan)
    assert sorted(o.shards[0].rank for o in pplan) == [0, 0, 1, 1]


def test_partitioner_overflow_raises():
    port, jax, ptopo, jtopo = _enum_both(
        2, [(10_000_000, 128, "huge", ["f"])], ["TABLE_WISE"],
        hbm_cap=1024 * 1024)
    with pytest.raises(PlannerError, match="no device can hold"):
        GreedyPerfPartitioner().partition(port, ptopo)
    with pytest.raises(JPlannerError, match="no device can hold"):
        JPartitioner().partition(jax, jtopo)


def test_planner_end_to_end():
    port_plan, _, pp = _plan_both(8, TABLES, path="ebc", batch_size=4096)
    entries = port_plan.get_plan_for_module("ebc")
    assert set(entries) == {"big", "mid", "small"}
    assert entries["big"].sharding_type is not ShardingType.DATA_PARALLEL
    assert pp.last_stats and "big" in pp.last_stats


def test_planner_respects_constraints():
    port_plan, _, _ = _plan_both(
        8, TABLES, {"big": {"sharding_types": ["ROW_WISE"]}})
    assert port_plan.plan["m"]["big"].sharding_type is ShardingType.ROW_WISE


def test_planner_infeasible_raises():
    ptopo, jtopo = _topos(2, hbm_cap=64 * 1024)
    pt, jt = _cfgs(TABLES)
    with pytest.raises(PlannerError, match="feasible"):
        EmbeddingShardingPlanner(ptopo).plan(pt)
    with pytest.raises(JPlannerError, match="feasible"):
        JPlanner(jtopo).plan(jt)


def test_planner_plan_feeds_dmp():
    """Both planners agree at world size 8 and 1; the world-size-1 plan
    drives the port's DMP through a train step on the CPU."""
    specs = [(r, 16, f"t{i}", [f"f{i}"])
             for i, r in enumerate([5000, 300, 64])]
    path = "dlrm/sparse_arch/embedding_bag_collection"
    _plan_both(8, specs, path=path, batch_size=2)
    plan, _, _ = _plan_both(1, specs, path=path, batch_size=2)
    tables, _ = _cfgs(specs)
    dmp = DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(tables, device="meta"), 4,
                       (8, 16), (8, 1), device="meta")),
        plan=plan, device="cpu").init(0)
    rng = np.random.RandomState(0)
    B = 16
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(3)],
        np.concatenate([rng.randint(0, r, B) for r in (5000, 300, 64)])
        .astype(np.int32), np.ones(3 * B, np.int32))
    loss, _ = dmp.make_train_step()(
        torch.as_tensor(rng.randn(B, 4).astype(np.float32)), kjt,
        torch.as_tensor((rng.rand(B) > 0.5).astype(np.float32)))
    assert torch.isfinite(loss)


def test_planner_falls_back_to_uvm_caching():
    port_plan, _, _ = _plan_both(
        8, [(80_000_000, 128, "huge", ["fh"]), (1000, 128, "small", ["fs"])],
        {"huge": {"sharding_types": ["TABLE_WISE"]}}, batch_size=256)
    entries = port_plan.plan["m"]
    assert entries["huge"].compute_kernel is ComputeKernel.FUSED_UVM_CACHING
    assert entries["small"].compute_kernel is ComputeKernel.FUSED


def test_planner_hierarchical_twrw():
    specs = [(1000, 64, f"h{i}", [f"f{i}"]) for i in range(4)]
    port_plan, _, _ = _plan_both(
        8, specs, {s[2]: {"sharding_types": ["TABLE_ROW_WISE"]}
                   for s in specs},
        local_world_size=4, batch_size=64)
    hosts = []
    for ps in port_plan.plan["m"].values():
        assert ps.sharding_type is ShardingType.TABLE_ROW_WISE
        assert sorted(ps.ranks) == [ps.host * 4 + l for l in range(4)]
        hosts.append(ps.host)
    assert set(hosts) == {0, 1}


def _fake_env(world_size, local_size, device="cpu"):
    """An env reporting `world_size` ranks (rank 0) with no group: the
    sharded modules build their rank-0 block and make no call."""
    env = ShardingEnv(device)
    env.world_size, env.local_size = world_size, local_size
    return env


@pytest.mark.parametrize("st,dim", [("TABLE_ROW_WISE", 64),
                                    ("TABLE_COLUMN_WISE", 128)],
                         ids=["twrw", "twcw"])
def test_planner_hierarchical_plan_feeds_sharded_ebc(st, dim):
    """A planned TWRW / TWCW plan (equal in both planners) builds the
    port's sharded EBC for rank 0 of that world, its block of JAX's
    layout, [1, rows, cols]."""
    port_plan, _, _ = _plan_both(8, [(64, dim, "h0", ["f0"])],
                                 {"h0": {"sharding_types": [st]}},
                                 local_world_size=4, batch_size=16)
    ps = port_plan.plan["m"]["h0"]
    assert ps.sharding_type is ShardingType[st] and ps.host in (0, 1)
    tables, _ = _cfgs([(64, dim, "h0", ["f0"])])
    sebc = ShardedEmbeddingBagCollection(_fake_env(8, 4), tables,
                                         port_plan.plan["m"])
    (strat,) = sebc.strategies
    rows = 128 if st == "TABLE_ROW_WISE" else 128  # ROW_TILE-padded
    cols = 64 if st == "TABLE_ROW_WISE" else 32
    assert tuple(strat.weights.shape) == (1, rows, cols)


def test_dp_grad_sync_traffic_hand_computed():
    n, B, D = 8, 512, 64
    (port,), _, ptopo, _ = _enum_both(n, [(1000, D, "t", ["f"])],
                                      ["DATA_PARALLEL"], batch_size=B)
    rows = B * C.POOLING_FACTOR_DEFAULT
    compute = JAX_COSTS.lookup_s(rows) + JAX_COSTS.update_s(rows, 1000 * D * 4)
    output_dist = (B * C.POOLING_FACTOR_DEFAULT * D * 4 * n) / ptopo.intra_bw
    assert port.shards[0].perf == pytest.approx(2.0 * output_dist + compute,
                                                rel=1e-9)
    (port2,), _, _, _ = _enum_both(2 * n, [(1000, D, "t", ["f"])],
                                   ["DATA_PARALLEL"], batch_size=B)
    assert port2.shards[0].perf > port.shards[0].perf


def test_planner_flips_large_batch_table_away_from_dp():
    port_plan, _, _ = _plan_both(
        8, [(2048, 128, "hot", ["f_hot"])],
        {"hot": {"pooling_factors": [64.0]}}, batch_size=4096)
    assert port_plan.plan["m"]["hot"].sharding_type is not \
        ShardingType.DATA_PARALLEL


# -- beyond tests/test_planner.py ---------------------------------------------

TOWER_SPECS = [(500, 16, "a0", ["fa0"]), (300, 16, "a1", ["fa1", "fa2"]),
               (400, 16, "b0", ["fb0"]), (250, 16, "c0", ["fc0"])]
TAGS = {"a0": "tower_0", "a1": "tower_0", "b0": "tower_1", "c0": "tower_2"}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tower_tags_plan_table_wise_on_one_rank(n):
    """Dependency tags enumerate TABLE_WISE only, whatever the allowed
    types, in both enumerators, and the partitioner keeps each tag's
    tables on one rank, as JAX's does."""
    constraints = {name: {"sharding_types": [st.name for st in ShardingType],
                          "dependency": tag} for name, tag in TAGS.items()}
    pc, jc = _constraints(constraints)
    ptopo, jtopo = _topos(n)
    pt, jt = _cfgs(TOWER_SPECS)
    port = EmbeddingEnumerator(ptopo).enumerate(pt, pc)
    jax = JEnum(jtopo).enumerate(jt, jc)
    _same_options(port, jax)
    assert {o.sharding_type for o in port} == {ShardingType.TABLE_WISE}
    plan, _, _ = _plan_both(n, TOWER_SPECS, constraints)
    ranks = {name: ps.ranks for name, ps in plan.plan["m"].items()}
    assert ranks["a0"] == ranks["a1"]
    assert all(len(r) == 1 for r in ranks.values())


@pytest.mark.parametrize("case", ["towers_round_robin", "dp_under_64_rows"])
def test_default_plan_falls_back_as_jax_on_a_planner_error(case):
    """Where the planner finds no plan (a 102 GB table, over even the
    UVM cache's share of a v5e): towers round-robin over the ranks by tag,
    else DATA_PARALLEL under 64 rows and ROW_WISE above, as JAX's."""
    huge = (200_000_000, 128, "huge", ["fh"])
    if case == "towers_round_robin":
        n, specs = 2, [huge, (40, 16, "b0", ["fb0"]), (90, 16, "c0", ["fc0"])]
        deps = {"huge": "tower_0", "b0": "tower_1", "c0": "tower_2"}
        sharders = (EmbeddingTowerCollectionSharder(), JTowerSharder())
    else:
        n, specs, deps = 1, [huge, (40, 16, "s", ["fs"])], None
        sharders = (EmbeddingBagCollectionSharder(), JEbcSharder())
    ptopo, _ = _topos(n)
    pt, jt = _cfgs(specs)
    with pytest.raises(PlannerError):
        EmbeddingShardingPlanner(ptopo, constraints=_constraints(
            {s[2]: {"sharding_types": [t.name for t in
                                       sharders[0].sharding_types()],
                    "dependency": (deps or {}).get(s[2])}
             for s in specs})[0]).plan(pt)
    env = types.SimpleNamespace(world_size=n)
    port = _default_plan(pt, env, sharders[0], deps, topology=ptopo)
    jax = j_default_plan(jt, env, sharders[1], deps)
    assert list(port) == list(jax)
    for name in port:
        assert (JT[port[name].sharding_type], port[name].ranks) == (
            jax[name].sharding_type, jax[name].ranks)
    if case == "towers_round_robin":
        assert [port[k].ranks for k in ("huge", "b0", "c0")] == [[0], [1],
                                                                 [0]]
    else:
        assert port["s"].sharding_type is ShardingType.DATA_PARALLEL
        assert port["huge"].sharding_type is ShardingType.ROW_WISE


@pytest.mark.parametrize("n", [2, 4])
def test_plan_quant_ranks_matches_jax(n):
    from torchrec_tpu_torch.inference.modules import _plan_quant_ranks

    specs = [(r, 16, f"t{i}", [f"f{i}"])
             for i, r in enumerate([5000, 300, 64, 2000, 700])]
    pt, jt = _cfgs(specs)
    env = types.SimpleNamespace(world_size=n)
    port = _plan_quant_ranks(
        env, {"m": types.SimpleNamespace(tables=pt)},
        topology=_topos(n)[0])
    jax = j_quant_ranks(env, {"m": types.SimpleNamespace(tables=jt)})
    assert port == jax
    assert set(port["m"].values()) == set(range(n))


# -- the card's own numbers ----------------------------------------------------

BENCH_TABLES = [EmbeddingBagConfig(num_embeddings=100_000, embedding_dim=128,
                                   name=f"t{i}", feature_names=[f"f{i}"])
                for i in range(26)]


def test_port_holds_no_accelerator_number_of_the_jax_planner():
    """The port's defaults are the card's: no JAX spec or cost function
    is the default, and the update cost has no shard-size term."""
    topo = Topology(8)
    assert topo.device is C.H100_SXM and topo.cost_model is C.H100_COSTS
    assert topo.hbm_mem_bw == 3.35e12 and topo.intra_bw == 450e9
    assert C.h100_update_s(1000, 1e6) == C.h100_update_s(1000, 1e12)
    for v in (jcm.GATHER_NS_PER_ROW, jcm.SCATTER_NS_PER_ROW,
              jcm.STREAM_BW_BYTES_S, JC.FUSED_KERNEL_BW_FRACTION):
        assert v not in (C.LOOKUP_NS_PER_SLOT, C.UPDATE_NS_PER_ROW,
                         C.FUSED_KERNEL_BW_FRACTION)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bench_tables_plan_on_the_card_and_build_a_dmp(n):
    """bench.py's 26 tables of 100,000 x 128 plan without error on n
    H100s (local size min(n, 8)); a DLRMTrain DMP given no plan holds the
    planner's plan and builds rank 0 on `meta`."""
    local = min(n, 8)
    planner = EmbeddingShardingPlanner(
        Topology(n, local_world_size=local, batch_size=8192 // n),
        constraints={t.name: ParameterConstraints(
            sharding_types=EmbeddingBagCollectionSharder().sharding_types())
            for t in BENCH_TABLES})
    want = planner.plan(BENCH_TABLES, module_path="m").plan["m"]
    assert set(want) == {t.name for t in BENCH_TABLES}
    assert planner.last_stats
    env = _fake_env(n, local, "meta")
    dmp = DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(BENCH_TABLES, device="meta"),
                       13, (512, 256, 128), (1024, 1024, 512, 256, 1),
                       device="meta")), env=env)
    got = dmp.plan.plan["dlrm/sparse_arch/embedding_bag_collection"]
    direct = _default_plan(BENCH_TABLES, env, EmbeddingBagCollectionSharder())
    assert got == direct
    assert all(p.sharding_type in ShardingType for p in got.values())
    for sebc in dmp.sharded_ebcs.values():
        for s in sebc.strategies:
            assert s.weights.is_meta


def test_default_plan_takes_the_env_local_size():
    """The DMP plans on a Topology of the env's world size and local size
    (JAX's default plan takes the world size alone, one host): on two
    hosts of two ranks a table constrained to TABLE_ROW_WISE plans over a
    host's local ranks, as the planner called directly gives it."""
    from torchrec_tpu_torch.parallel.sharders import ModuleSharder

    class TwrwSharder(ModuleSharder):
        def sharding_types(self, device_type="cuda"):
            return [ShardingType.TABLE_ROW_WISE]

    tables, _ = _cfgs([(1000, 64, "h0", ["f0"])])
    env = _fake_env(4, 2)
    got = _default_plan(tables, env, TwrwSharder())
    want = EmbeddingShardingPlanner(Topology(4, local_world_size=2),
                                    constraints={"h0": ParameterConstraints(
                                        sharding_types=[
                                            ShardingType.TABLE_ROW_WISE])}
                                    ).plan(tables, "m").plan["m"]
    assert got == want
    assert got["h0"].sharding_type is ShardingType.TABLE_ROW_WISE
    assert sorted(got["h0"].ranks) in ([0, 1], [2, 3])
    # on one host of four (JAX's topology) the same table has no plan, and
    # the fallback takes ROW_WISE
    one_host = _default_plan(tables, _fake_env(4, 4), TwrwSharder())
    assert one_host["h0"].sharding_type is ShardingType.ROW_WISE
