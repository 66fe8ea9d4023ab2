"""K1j, the offsets form of the pooled lookup (csrc/tbe_lookup.cu), and the
jagged route of the sharded EBC on a CUDA card.

Marked `chip`: each test skips without a card (decided in the `cuda_card`
fixture, never at import). On a card, from the repository root:

    python -m pytest tests/test_torch_port_dcn_card.py -m chip

The kernel against its plain version at widths from 8 to 256 columns
(the narrow lane groups, D = 128's warp a bag, the column chunks past 128,
D = 10 and 130's pair and element access), f32 and bf16 tables, with and
without coefficients, bags cut at a cap, empty bags and ids past the table;
and at MLPerf DLRM-DCNv2's shape (8,192 examples, 26 features of 1 to 100
ids, D = 128). The kernel's sums are one FMA chain a column over the bag's
ids in order, as K1's are, so it equals K1 on the same bags padded, bit for
bit, and the CPU's plain version (a multiply, then torch's sum) within
2^-20 of the bag's sum of |c| |w|. Then the sharded EBC's jagged forward
and update run under `torch.cuda.set_sync_debug_mode("error")`, equal the
padded route's (the forward bit for bit; the update within the reach of
the atomic row totals' order, which a total whose terms cancel widens),
and a DLRM_DCN DMP step launches one K1j and no K1, where the DLRM's step
on a PaddedSparseBatch launches K1 and no K1j. This file imports no JAX.
"""

import pytest
import torch

from torchrec_tpu_torch.models import DLRM, DLRM_DCN, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
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
from torchrec_tpu_torch.utils import tracing

# MLPerf DLRM-DCNv2's ids a feature
MLPERF_LENGTHS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                  12, 100, 27, 10, 3, 1, 1)
LOOKUPS = ("tbe_lookup", "tbe_lookup_half", "tbe_lookup_jagged")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launched(before, names):
    after = tracing.counts()
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def _case(seed, R, D, lengths, dtype, slack=0):
    """(w, ids, offsets, coeff) on the CPU: ids a little past the table
    on both sides, coefficients in [0.25, 1.25) rounded to the table's
    dtype as `pooled_lookup` rounds them."""
    g = torch.Generator().manual_seed(seed)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32),
                         lengths.cumsum(0).to(torch.int32)])
    N = int(offsets[-1]) + slack
    ids = torch.randint(-2, R + 2, (N,), generator=g, dtype=torch.int32)
    coeff = (torch.rand(N, generator=g) + 0.25).to(dtype).float()
    w = torch.randn(R, D, generator=g).to(dtype)
    return w, ids, offsets, coeff


def _padded(ids, offsets, coeff, L):
    """The same bags padded to L slots (K1's input)."""
    lengths = (offsets[1:] - offsets[:-1]).clamp(max=L)
    col = torch.arange(L)
    real = col[None, :] < lengths[:, None]
    src = (offsets[:-1, None].long() + col).clamp(0, max(ids.shape[0] - 1,
                                                         0))
    flat = torch.where(real, ids[src], 0).to(torch.int32).contiguous()
    c = torch.where(real, coeff[src] if coeff is not None else 1.0, 0.0)
    return flat, c.contiguous()


def _hold(dev, w, ids, offsets, coeff, cap, L):
    """K1j against its plain version and against K1 on the padded bags."""
    before = tracing.counts()
    got = tl.tbe_lookup_jagged_forward(w.to(dev), ids.to(dev),
                                       offsets.to(dev),
                                       None if coeff is None
                                       else coeff.to(dev), cap)
    assert _launched(before, LOOKUPS)["tbe_lookup_jagged"] == 1
    plain = tl.tbe_lookup_jagged_reference(w, ids, offsets, coeff, cap)
    flat, c = _padded(ids, offsets, coeff, L)
    k1 = tl.tbe_lookup_pooled_forward(w.to(dev), flat.to(dev), c.to(dev))
    assert torch.equal(got, k1)
    scale = tl.tbe_lookup_pooled_reference(w.float().abs(), flat, c.abs())
    assert torch.all((got.cpu() - plain).abs() <= 2.0 ** -20 * scale
                     + 1e-30)


@pytest.mark.chip
@pytest.mark.parametrize("D", [8, 10, 64, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_kernel_matches_the_plain_version(cuda_card, D, dtype, with_coeff):
    g = torch.Generator().manual_seed(D)
    lengths = torch.randint(0, 40, (3001,), generator=g, dtype=torch.int32)
    lengths[::7] = 0
    w, ids, offsets, coeff = _case(D, 5003, D, lengths, dtype, slack=11)
    c = coeff if with_coeff else None
    _hold(cuda_card, w, ids, offsets, c, tl.NO_CAP, int(lengths.max()))
    _hold(cuda_card, w, ids, offsets, c, 17, 17)


@pytest.mark.chip
def test_kernel_at_the_mlperf_shape(cuda_card):
    B = 8192
    lengths = torch.tensor(MLPERF_LENGTHS, dtype=torch.int32)[
        :, None].expand(-1, B).reshape(-1).contiguous()
    w, ids, offsets, _ = _case(1, 200_000, 128, lengths, torch.float32)
    _hold(cuda_card, w, ids, offsets, None, 100, 100)


ROWS = (300, 1000, 77, 5000)
KEYS = tuple(f"f{i}" for i in range(len(ROWS)))


def _strategy(dev, optim):
    cfg = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=128,
                              name=f"t{i}", feature_names=[k],
                              pooling=PoolingType.MEAN if i == 2
                              else PoolingType.SUM)
           for i, (r, k) in enumerate(zip(ROWS, KEYS))]
    (meta,) = group_tables(cfg, embedding_names_by_table(cfg),
                           {c.name: ParameterSharding(
                               ShardingType.DATA_PARALLEL) for c in cfg})
    strat = create_sharding_strategy(ShardingEnv(dev), meta, optim, {})
    strat.weights = strat.init_weights(
        torch.Generator(device=dev).manual_seed(3))
    return strat


def _kjt(dev, B=512, L=9):
    g = torch.Generator().manual_seed(4)
    lengths = torch.randint(0, L + 3, (len(ROWS) * B,), generator=g,
                            dtype=torch.int32)
    per = lengths.reshape(len(ROWS), B).sum(dim=1)
    values = torch.cat([torch.randint(0, r, (int(n),), generator=g,
                                      dtype=torch.int32)
                        for r, n in zip(ROWS, per)])
    return KeyedJaggedTensor.from_lengths(KEYS, values, lengths).to(dev)


@pytest.mark.chip
@pytest.mark.parametrize("optim", ["ADAGRAD", "ROWWISE_ADAGRAD"])
def test_jagged_route_does_not_synchronise(cuda_card, optim):
    L = 9
    kjt = _kjt(cuda_card, L=L)
    jagged = _strategy(cuda_card, EmbOptimType[optim])
    padded = _strategy(cuda_card, EmbOptimType[optim])
    d = torch.randn(len(ROWS), 512, 128, device=cuda_card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        route = jagged.jagged_route(kjt, L)
        out = jagged.forward_jagged(route)
        jagged.update_jagged(route, d, 0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sb = kjt.to_padded(L)
    assert torch.equal(out, padded(sb))
    padded.update(sb, d, 0.05)
    torch.testing.assert_close(jagged.weights, padded.weights, rtol=1e-5,
                               atol=1e-6)
    reach = _sum_of_squares_reach(route, d, padded.momentum1)
    assert torch.all((jagged.momentum1 - padded.momentum1).abs() <= reach)


def _sum_of_squares_reach(route, d, m):
    """How far the first step's Adagrad state m (g^2 a column, or its row
    mean under ROWWISE_ADAGRAD) may move when a row's gradient total g adds
    its c terms g_i in another order: the atomic segment sums of the two
    routes each lie within (c - 1) 2^-24 sum |g_i| of the exact total (a
    total whose terms cancel moves far more, relative to itself, than one
    whose terms do not), so g^2 within 2 |g| dg + dg^2 with dg twice that,
    and m within two more roundings."""
    D = d.shape[-1]
    valid = route.valid
    contrib = d.reshape(-1, D)[route.bag].abs()
    if route.coeff is not None:
        contrib = contrib * route.coeff.abs()[:, None]
    rows = route.gids.long()[valid]
    R = m.shape[0]
    abs_sum = torch.zeros(R, D, device=d.device).index_add_(
        0, rows, contrib[valid])
    count = torch.zeros(R, device=d.device).index_add_(
        0, rows, torch.ones_like(rows, dtype=torch.float32))
    dg = 2 * (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum
    g = abs_sum if m.dim() == 1 else m.sqrt()
    if m.dim() == 1:  # the row's mean of g^2: bound each column by sum |g_i|
        return (2 * g * dg + dg * dg).mean(1) + 2.0 ** -21 * m + 1e-30
    return 2 * g * dg + dg * dg + 2.0 ** -22 * m + 1e-30


def _dmp(dev, model, optim):
    return DistributedModelParallel(
        model, fused_optim=optim, fused_params={"learning_rate": 0.01},
        device=dev).init(0)


def _tables(D):
    return [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                               name=f"t{i}", feature_names=[k])
            for i, (r, k) in enumerate(zip(ROWS, KEYS))]


@pytest.mark.chip
def test_dmp_steps_launch_their_lookup(cuda_card):
    kjt = _kjt(cuda_card)
    B = kjt.stride
    dense = torch.randn(B, 13, device=cuda_card)
    labels = (torch.rand(B, device=cuda_card) < 0.25).float()
    watched = (*LOOKUPS, "fused_update_adagrad",
               "fused_update_rowwise_adagrad")
    dcn = DLRM_DCN(EmbeddingBagCollection(_tables(128), max_feature_length=12,
                                          device="meta"),
                   13, (64, 128), (256, 1), 3, 64, device="meta")
    step = _dmp(cuda_card, DLRMTrain(dcn), EmbOptimType.ADAGRAD
                ).make_train_step()
    step(dense, kjt, labels)  # kernels built
    before = tracing.counts()
    step(dense, kjt, labels)
    torch.cuda.synchronize()
    assert _launched(before, watched) == {
        "tbe_lookup": 0, "tbe_lookup_half": 0, "tbe_lookup_jagged": 1,
        "fused_update_adagrad": 1, "fused_update_rowwise_adagrad": 0}
    dlrm = DLRM(EmbeddingBagCollection(_tables(64), max_feature_length=12,
                                       device="meta"),
                13, (64, 64), (64, 1), device="meta")
    step = _dmp(cuda_card, DLRMTrain(dlrm), EmbOptimType.ROWWISE_ADAGRAD
                ).make_train_step()
    sb = kjt.to_padded(12)
    assert isinstance(sb, PaddedSparseBatch)
    step(dense, sb, labels)
    before = tracing.counts()
    step(dense, sb, labels)
    torch.cuda.synchronize()
    assert _launched(before, watched) == {
        "tbe_lookup": 1, "tbe_lookup_half": 0, "tbe_lookup_jagged": 0,
        "fused_update_adagrad": 0, "fused_update_rowwise_adagrad": 1}
