"""torchrec_tpu_torch: the PyTorch + CUDA port of torchrec_tpu.

The JAX package `torchrec_tpu` is the reference; each module here mirrors
the module of the same path there. The port serves and trains a row-wise
sharded DLRM (float and half tables, every fused optimizer, a
position-weighted variant), BERT4Rec (its item table in a sharded
EmbeddingCollection) and SimpleDeepFMNN on one GPU, with the optimizer
stack of `optim/` (FQN-keyed state, warmup schedules, gradient
clipping), and serves the DLRM quantized to int-N tables (`quant/`,
`inference/`). Its TPU kernels are
hand-written CUDA kernels: the pooled embedding lookup K1
(csrc/tbe_lookup.cu, bound in ops/tbe_lookup.py), the fused embedding
updates K2-K7 (csrc/fused_update.cu, bound in ops/fused_update_kernels.py)
and the row gather K8 (csrc/gather_rows.cu, bound in ops/gather_rows.py);
the quantized lookup Kq (csrc/quant_lookup.cu, bound in
ops/quant_lookup.py) stands for the JAX package's XLA code.

The package exports the JAX package's top-level names: the sparse
containers, the embedding configs and modules, the feature processor,
and, imported on first use, DistributedModelParallel and
EmbeddingShardingPlanner. Its entry points are the examples
(`python -m torchrec_tpu_torch.examples.dlrm_main`, `dlrm_predict`,
`bert4rec_main`), which train, package and serve on the card.
"""

from torchrec_tpu_torch.sparse import (  # noqa: F401
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
)
from torchrec_tpu_torch.modules.embedding_configs import (  # noqa: F401
    DataType,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (  # noqa: F401
    EmbeddingBagCollection,
    EmbeddingCollection,
)
from torchrec_tpu_torch.modules.feature_processor import (  # noqa: F401
    FeatureProcessedEmbeddingBagCollection,
    PositionWeightedModule,
)


def __getattr__(name):
    """The heavyweight exports, imported on first use."""
    if name == "DistributedModelParallel":
        from torchrec_tpu_torch.parallel import DistributedModelParallel

        return DistributedModelParallel
    if name == "EmbeddingShardingPlanner":
        from torchrec_tpu_torch.planner import EmbeddingShardingPlanner

        return EmbeddingShardingPlanner
    raise AttributeError(
        f"module 'torchrec_tpu_torch' has no attribute {name!r}")
