from torchrec_tpu_torch.datasets.utils import Batch  # noqa: F401
from torchrec_tpu_torch.datasets.random import RandomRecDataset  # noqa: F401
