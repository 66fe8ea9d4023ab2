from torchrec_tpu_torch.inference.batching import (  # noqa: F401
    BatchingPredictServer,
    make_dlrm_collate,
)
from torchrec_tpu_torch.inference.native_batching import (  # noqa: F401
    NativePredictServer,
    PredictClient,
    native_serving_available,
)
from torchrec_tpu_torch.inference.modules import (  # noqa: F401
    PredictFactory,
    PredictFactoryPackager,
    PredictModule,
    ShardedPredictModule,
    quantize_embeddings,
    shard_quantized,
)
