from torchrec_tpu_torch.models.bert4rec import (  # noqa: F401
    BERT4Rec,
    BERT4RecTrain,
    HistoryArch,
    TransformerBlock,
    make_item_embedding_collection,
)
from torchrec_tpu_torch.models.dlrm import (  # noqa: F401
    DLRM,
    DLRM_DCN,
    DLRMTrain,
    DenseArch,
    InteractionArch,
    InteractionDCNArch,
    OverArch,
    SparseArch,
)
from torchrec_tpu_torch.models.deepfm import (  # noqa: F401
    FMInteractionArch,
    SimpleDeepFMNN,
)
