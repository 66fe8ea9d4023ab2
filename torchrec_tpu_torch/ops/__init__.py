from torchrec_tpu_torch.ops.embedding import (  # noqa: F401
    PoolingMode,
    batched_embedding_lookup,
    embedding_bag_lookup,
    lookup_rows,
    make_row_offsets,
    pooled_lookup,
    sequence_embedding_lookup,
)
from torchrec_tpu_torch.ops.fused_update import (  # noqa: F401
    EmbOptimType,
    FusedOptimizerState,
    apply_fused_update,
    dedup_row_grads,
    init_fused_optimizer_state,
    pooled_grad_to_row_grads,
    run_total_row_grads,
)
