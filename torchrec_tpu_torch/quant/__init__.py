from torchrec_tpu_torch.quant.embedding_modules import (  # noqa: F401
    QuantEmbeddingBagCollection,
)
