"""torchrec_tpu_torch: the PyTorch + CUDA port of torchrec_tpu.

The JAX package `torchrec_tpu` is the reference; each module here mirrors
the module of the same path there. The port serves and trains a row-wise
sharded DLRM with float tables on one GPU. Its TPU kernels are hand-written
CUDA kernels: the pooled embedding lookup (csrc/tbe_lookup.cu, bound in
ops/tbe_lookup.py) and the fused EXACT_SGD and ROWWISE_ADAGRAD embedding
updates (csrc/fused_update.cu, bound in ops/fused_update_kernels.py).
"""
