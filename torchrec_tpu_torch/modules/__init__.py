from torchrec_tpu_torch.modules.embedding_configs import (  # noqa: F401
    BaseEmbeddingConfig,
    DataType,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.modules.embedding_modules import (  # noqa: F401
    EmbeddingBagCollection,
    EmbeddingCollection,
)
from torchrec_tpu_torch.modules.activation import (  # noqa: F401
    LayerNorm,
    SwishLayerNorm,
)
from torchrec_tpu_torch.modules.feature_processor import (  # noqa: F401
    FeatureProcessedEmbeddingBagCollection,
    PositionWeightedModule,
)
from torchrec_tpu_torch.modules.mlp import MLP, Perceptron  # noqa: F401
from torchrec_tpu_torch.modules.dense import Dense  # noqa: F401
from torchrec_tpu_torch.modules.deepfm import (  # noqa: F401
    DeepFM,
    FactorizationMachine,
)
from torchrec_tpu_torch.modules.crossnet import (  # noqa: F401
    CrossNet,
    LowRankCrossNet,
    LowRankMixtureCrossNet,
    VectorCrossNet,
)
from torchrec_tpu_torch.modules.embedding_tower import (  # noqa: F401
    EmbeddingTower,
    EmbeddingTowerCollection,
)
