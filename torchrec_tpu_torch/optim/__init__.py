from torchrec_tpu_torch.optim.keyed import (  # noqa: F401
    CombinedOptimizer,
    KeyedOptimizer,
    KeyedOptimizerWrapper,
    OptimizerWrapper,
    flatten_with_fqns,
    init_optimizer_state,
    unflatten_from_fqns,
)
from torchrec_tpu_torch.optim.warmup import (  # noqa: F401
    WarmupOptimizer,
    WarmupPolicy,
    WarmupStage,
    make_warmup_schedule,
    warmup_optimizer,
)
from torchrec_tpu_torch.optim.clipping import (  # noqa: F401
    GradientClipping,
    GradientClippingOptimizer,
    gradient_clipping,
)
