from torchrec_tpu_torch.parallel.types import (  # noqa: F401
    ComputeKernel,
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.parallel.sharded_ebc import (  # noqa: F401
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.sharded_ec import (  # noqa: F401
    ShardedEmbeddingCollection,
)
from torchrec_tpu_torch.parallel.dmp import (  # noqa: F401
    DistributedModelParallel,
)
from torchrec_tpu_torch.parallel.sharded_bag import (  # noqa: F401
    ShardedEmbeddingBag,
)
from torchrec_tpu_torch.parallel.tower_sharding import (  # noqa: F401
    ShardedEmbeddingTower,
    ShardedEmbeddingTowerCollection,
    TowerSpec,
)
from torchrec_tpu_torch.parallel.variable_batch import (  # noqa: F401
    VariableBatch,
    masked_bce_with_logits,
    masked_mean,
)
from torchrec_tpu_torch.parallel.sharders import (  # noqa: F401
    EmbeddingBagCollectionSharder,
    EmbeddingCollectionSharder,
    ModuleSharder,
    QuantEmbeddingBagCollectionSharder,
    get_default_sharders,
)


def __getattr__(name):
    """ShardedQuantEmbeddingBagCollection, imported on first use: its
    module imports quant/, which imports this package's strategies."""
    if name == "ShardedQuantEmbeddingBagCollection":
        from torchrec_tpu_torch.parallel.quant_sharded import (
            ShardedQuantEmbeddingBagCollection,
        )

        return ShardedQuantEmbeddingBagCollection
    raise AttributeError(
        f"module 'torchrec_tpu_torch.parallel' has no attribute {name!r}")
