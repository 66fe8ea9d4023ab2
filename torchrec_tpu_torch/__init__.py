"""torchrec_tpu_torch: the PyTorch + CUDA port of torchrec_tpu.

The JAX package `torchrec_tpu` is the reference; each module here mirrors
the module of the same path there. This slice carries the float-table
serving forward of a row-wise sharded DLRM on one GPU; its one TPU kernel,
the pooled embedding lookup, is a hand-written CUDA kernel
(csrc/tbe_lookup.cu, bound in ops/tbe_lookup.py).
"""
