"""The dot-interaction kernel (csrc/dot_interaction.cu) on a CUDA card.

Marked `chip`: each test skips without a card (decided in the `cuda_card`
fixture, never at import). On a card, from the repository root:

    python -m pytest tests/test_torch_port_dot_interaction_card.py -m chip

The kernel against its plain version on the card at the Criteo Kaggle
DLRM's shape (B = 65,536, n = 27, D = 64), at the MLPerf DLRM's D = 128,
at widths not a multiple of 4 (D = 63, 66, 3: the element access) and at
the largest n the kernel takes; and one DLRM train step launching each
direction once. This file imports no JAX (the JAX comparisons are the CPU
tests' in test_torch_port_dot_interaction.py).

The forward sums each product as one f32 FMA chain over ascending d, as
cuBLAS's batched f32 GEMM does, so it equals the plain version's `bmm`
bit for bit, except on the 65,536th example of a batch that large: cuBLAS
takes 65,535 examples a launch and sums the one left over with another
kernel in another order. Everywhere it lies within D * 2^-24 of the
float64 products' |a| . |b| scale. The backward sums S C in another order
than the plain version's `bmm`: within 1e-5 of the gradient's scale.
"""

import numpy as np
import pytest
import torch

from torchrec_tpu_torch.ops import dot_interaction as di
from torchrec_tpu_torch.utils import tracing

KERNELS = ("dot_interaction", "dot_interaction_bwd")
SHAPES = {  # name: (B, F, D)
    "kaggle": (65536, 26, 64),
    "mlperf_d128": (8192, 26, 128),
    "ragged_d63": (4099, 26, 63),
    "even_d66": (513, 30, 66),
    "elements_d3": (1000, 5, 3),
    "widest_n64": (777, 63, 130),
}
CUBLAS_BATCH = 65535  # examples a cuBLAS batched-GEMM launch takes


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launched(before):
    after = tracing.counts()
    return {k: after.get(k, 0) - before.get(k, 0) for k in KERNELS}


@pytest.mark.chip
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_plain_version(cuda_card, shape):
    B, F, D = SHAPES[shape]
    n = F + 1
    g = torch.Generator(device=cuda_card).manual_seed(B + F + D)
    dense = torch.randn(B, D, device=cuda_card, generator=g)
    sparse = torch.randn(B, F, D, device=cuda_card, generator=g)
    grad = torch.randn(B, D + n * (n - 1) // 2, device=cuda_card,
                       generator=g)
    before = tracing.counts()
    out = di.dot_interaction_forward(dense, sparse)
    d_dense, d_sparse = di.dot_interaction_backward(grad, dense, sparse)
    torch.cuda.synchronize()
    assert _launched(before) == {k: 1 for k in KERNELS}

    plain = di.dot_interaction_reference(dense, sparse)
    differ = (out != plain).any(dim=1).nonzero().flatten().tolist()
    assert differ == [] or differ == [CUBLAS_BATCH], differ
    exact = di.dot_interaction_reference(dense.double(), sparse.double())
    scale = di.dot_interaction_reference(dense.abs().double(),
                                         sparse.abs().double())
    err = ((out.double() - exact).abs() / scale.clamp_min(1e-30)).max()
    assert err <= D * 2.0 ** -24, float(err)

    want = di.dot_interaction_backward_reference(grad, dense, sparse)
    for got, ref in zip((d_dense, d_sparse), want):
        tol = 1e-5 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.chip
def test_a_dlrm_train_step_launches_each_direction_once(cuda_card):
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    rows, D, B, dense_in = (100, 37, 500), 64, 256, 13
    tables = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i, r in enumerate(rows)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=1, device="meta"),
        dense_in, (32, D), (32, 16, 1), device="meta"))
    plan = ShardingPlan({"dlrm/sparse_arch/embedding_bag_collection": {
        t.name: ParameterSharding(ShardingType.DATA_PARALLEL)
        for t in tables}})
    dmp = DistributedModelParallel(model, plan=plan, device="cuda").init(0)
    rng = np.random.RandomState(0)
    ids = np.concatenate([rng.randint(0, r, size=B) for r in rows])
    kjt = KeyedJaggedTensor.from_lengths(
        [t.feature_names[0] for t in tables], ids.astype(np.int32),
        np.ones(len(rows) * B, np.int32)).to("cuda")
    dense = torch.from_numpy(rng.randn(B, dense_in).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 2, B).astype(np.float32))
    batch = (dense.cuda(), kjt, labels.cuda())
    step, evaluate = dmp.make_train_step(), dmp.make_eval_fn()
    step(*batch)  # builds the kernels' libraries
    torch.cuda.synchronize()
    before = tracing.counts()
    loss, _ = step(*batch)
    torch.cuda.synchronize()
    assert _launched(before) == {"dot_interaction": 1,
                                 "dot_interaction_bwd": 1}
    assert torch.isfinite(loss)
    before = tracing.counts()
    evaluate(*batch)
    torch.cuda.synchronize()
    assert _launched(before) == {"dot_interaction": 1,
                                 "dot_interaction_bwd": 0}
