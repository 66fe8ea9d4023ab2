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
