from torchrec_tpu_torch.planner.constants import (  # noqa: F401
    H100_COSTS,
    H100_SXM,
    CostModel,
    DeviceSpec,
)
from torchrec_tpu_torch.planner.planners import (  # noqa: F401
    EmbeddingShardingPlanner,
    HeuristicalStorageReservation,
)
from torchrec_tpu_torch.planner.types import (  # noqa: F401
    ParameterConstraints,
    PlannerError,
    Topology,
)
