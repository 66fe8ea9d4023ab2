from torchrec_tpu_torch.models.dlrm import (  # noqa: F401
    DLRM,
    DLRMTrain,
    DenseArch,
    InteractionArch,
    OverArch,
    SparseArch,
)
