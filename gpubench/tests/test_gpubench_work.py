"""The operation and byte counts against hand counts at small shapes."""

import torch

from gpubench import registry, work
from gpubench.reference import deepfm, dlrm


def test_linear_flops():
    # 2 x (3*4 + 4*5) forward; training: the first layer x2, the second x3
    assert work.linear_flops([(3, 4), (4, 5)], train=False) == 64
    assert work.linear_flops([(3, 4), (4, 5)], train=True,
                             no_input_grad=(0,)) == 2 * 24 + 3 * 40


def test_dlrm_flops_by_hand():
    cfg = {"num_embeddings_per_feature": [5, 5], "embedding_dim": 4,
           "dense_in_features": 3, "dense_arch_layer_sizes": [6, 4],
           "over_arch_layer_sizes": [7, 1]}
    # over arch input: D + F(F+1)/2 = 4 + 3 = 7
    fwd = 2 * (3 * 6 + 6 * 4 + 7 * 7 + 7 * 1) + 2 * 3 * 3 * 4
    assert dlrm.flops_per_example(cfg, train=False) == fwd
    train = (2 * 2 * 3 * 6 + 3 * 2 * (6 * 4 + 7 * 7 + 7 * 1)
             + 3 * 2 * 3 * 3 * 4)
    assert dlrm.flops_per_example(cfg, train=True) == train


def test_dlrm_flops_at_kaggle_width():
    cfg = registry.data("configs", "criteo_kaggle_dlrm")
    # 308,224 dense arch + 93,312 Gram + 1,211,904 over arch, forward
    assert dlrm.flops_per_example(cfg, train=False) == 1_613_440


def test_deepfm_flops_by_hand():
    cfg = {"num_embeddings_per_feature": [5, 5, 5], "embedding_dim": 2,
           "dense_in_features": 3, "hidden_layer_size": 4,
           "deep_fm_dimension": 5}
    N = 2 * 4
    fwd = 2 * (3 * 4 + 4 * 2 + N * 5 + (2 + 5 + 1) * 1) + 3 * N
    assert deepfm.flops_per_example(cfg, train=False) == fwd


def test_distinct_rows_and_bytes():
    ids = torch.tensor([[[1], [1], [2]], [[0], [0], [0]]], dtype=torch.int32)
    lengths = torch.tensor([[1, 1, 1], [1, 0, 1]], dtype=torch.int32)
    assert work.distinct_rows(ids, lengths) == 3
    F, B, L, D = 2, 3, 1, 4
    ids = F * L  # ids an example
    inputs = F * B * L * 4 + F * B * 4
    assert work.lookup_bytes(3, F, B, ids, D) == (
        3 * D * 4 + inputs + F * B * D * 4)
    # rowwise Adagrad: row and momentum word read and written
    assert work.update_bytes(3, F, B, ids, D, 1) == (
        3 * 2 * (D * 4 + 4) + F * B * D * 4 + inputs)
    # int8: D bytes, scale and shift a row
    assert work.quant_lookup_bytes(3, F, B, ids, D, 8) == (
        3 * (D + 8) + inputs + F * B * D * 4)
    assert work.quant_lookup_bytes(3, F, B, ids, D, 4) == (
        3 * (D // 2 + 8) + inputs + F * B * D * 4)
