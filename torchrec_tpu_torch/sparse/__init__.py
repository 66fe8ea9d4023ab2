from torchrec_tpu_torch.sparse.jagged import (  # noqa: F401
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
    lengths_to_offsets,
    offsets_to_lengths,
    jagged_segment_ids,
    jagged_permute_indices,
)
