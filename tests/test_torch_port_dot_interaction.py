"""The DLRM's dot interaction (ops/dot_interaction.py) on the CPU.

Its plain version, forward and the explicit `S C` backward, held against
the autograd composition the DLRM ran before (cat, Gram `bmm`, the upper
triangle gathered with `triu_indices`, cat) and against the JAX package's
InteractionArch under `jax.vjp`, with and without a compute dtype; a
float64 gradcheck of the autograd Function; the wrapper's refusals of CUDA
tensors it does not take (fake CUDA tensors, which a CPU build can make).
The kernel itself runs on the card (test_torch_port_dot_interaction_card.py).

Tolerances: the forward is the composition's own operations, so equal;
against JAX and in the backward the sums run in another order, so within
1e-5 of the output's scale in f32. With a bf16 compute dtype both
packages round the inputs alike and sum in f32, so the forward is held
to 1e-5 of its scale too; the cotangent of the rounded inputs is rounded
to bf16 after its sum (in both packages), so one bf16 step separates the
gradients: at most 2^-7 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.models import InteractionArch as JInteractionArch
from torchrec_tpu_torch.models import InteractionArch
from torchrec_tpu_torch.ops import dot_interaction as di
from torchrec_tpu_torch.utils import tracing

CASES = [(F, D, B, dtype)
         for F in (1, 2, 26) for D in (3, 8, 64, 128) for B in (1, 5, 64)
         for dtype in (None, "bf16")]
IDS = [f"F{F}-D{D}-B{B}-{dtype or 'f32'}" for F, D, B, dtype in CASES]
TORCH_DTYPE = {None: None, "bf16": torch.bfloat16}
JAX_DTYPE = {None: None, "bf16": jnp.bfloat16}


def _inputs(F, D, B, seed=0):
    """dense [B, D], sparse [B, F, D] and an output cotangent, as numpy."""
    rng = np.random.RandomState(seed + 97 * F + D + 1000 * B)
    n = F + 1
    dense = rng.randn(B, D).astype(np.float32)
    sparse = rng.randn(B, F, D).astype(np.float32)
    grad = rng.randn(B, D + n * (n - 1) // 2).astype(np.float32)
    return dense, sparse, grad


def _composition(dense, sparse, dtype):
    """InteractionArch's forward before the kernel: autograd ops."""
    F = sparse.shape[1]
    combined = torch.cat([dense[:, None, :], sparse], dim=1)
    if dtype is not None:
        combined = combined.to(dtype)
    combined = combined.float()
    gram = torch.bmm(combined, combined.transpose(1, 2))
    iu, ju = torch.triu_indices(F + 1, F + 1, offset=1)
    return torch.cat([dense, gram[:, iu, ju]], dim=1)


def _port(fn, dense, sparse, grad):
    """fn(dense, sparse) and its gradients in both inputs."""
    d = torch.from_numpy(dense).requires_grad_()
    s = torch.from_numpy(sparse).requires_grad_()
    out = fn(d, s)
    dd, ds = torch.autograd.grad(out, [d, s], torch.from_numpy(grad))
    return out.detach().numpy(), dd.numpy(), ds.numpy()


def _tolerance(ref, dtype):
    scale = float(np.abs(ref).max()) or 1.0
    return scale * (2.0 ** -7 if dtype else 1e-5)


def _close(got, ref, dtype):
    """Within 2^-7 of the scale for a gradient under a bf16 compute
    dtype (`dtype` given), else 1e-5 of it."""
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=_tolerance(ref, dtype))


@pytest.mark.parametrize("F,D,B,dtype", CASES, ids=IDS)
def test_plain_version_matches_the_composition(F, D, B, dtype):
    dense, sparse, grad = _inputs(F, D, B)
    arch = InteractionArch(F, dtype=TORCH_DTYPE[dtype])
    got = _port(arch, dense, sparse, grad)
    ref = _port(lambda d, s: _composition(d, s, TORCH_DTYPE[dtype]),
                dense, sparse, grad)
    np.testing.assert_array_equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, dtype)


@pytest.mark.parametrize("F,D,B,dtype", CASES, ids=IDS)
def test_plain_version_matches_jax(F, D, B, dtype):
    dense, sparse, grad = _inputs(F, D, B, seed=1)
    got = _port(InteractionArch(F, dtype=TORCH_DTYPE[dtype]), dense, sparse,
                grad)
    arch = JInteractionArch(num_sparse_features=F, dtype=JAX_DTYPE[dtype])
    params = arch.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                       jnp.asarray(sparse))
    out, vjp = jax.vjp(lambda d, s: arch.apply(params, d, s),
                       jnp.asarray(dense), jnp.asarray(sparse))
    ref = (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(grad))))
    _close(got[0], ref[0], None)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, dtype)


def test_explicit_backward_is_the_composition_gradient():
    """The plain backward (S C) against autograd through the plain
    forward, in float64, where the two orders agree to rounding."""
    dense, sparse, grad = (x.astype(np.float64) for x in _inputs(26, 64, 9))
    d = torch.from_numpy(dense).requires_grad_()
    s = torch.from_numpy(sparse).requires_grad_()
    want = torch.autograd.grad(di.dot_interaction_reference(d, s), [d, s],
                               torch.from_numpy(grad))
    got = di.dot_interaction_backward_reference(
        torch.from_numpy(grad), torch.from_numpy(dense),
        torch.from_numpy(sparse))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("F,D,B", [(1, 3, 2), (4, 5, 3)])
def test_gradcheck_float64(F, D, B):
    g = torch.Generator().manual_seed(F * 10 + D)
    dense = torch.randn(B, D, dtype=torch.float64, generator=g,
                        requires_grad=True)
    sparse = torch.randn(B, F, D, dtype=torch.float64, generator=g,
                         requires_grad=True)
    assert torch.autograd.gradcheck(di.dot_interaction, (dense, sparse))


def test_zero_examples():
    out = di.dot_interaction(torch.zeros(0, 4), torch.zeros(0, 3, 4))
    assert out.shape == (0, 4 + 6)


def test_the_cpu_launches_nothing():
    dense, sparse, grad = _inputs(26, 8, 5)
    launches = tracing.counts()
    _port(di.dot_interaction, dense, sparse, grad)
    assert tracing.counts() == launches


def _fake_cuda(fn):
    """fn() on fake CUDA tensors (metadata only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


@pytest.mark.parametrize("case", [
    "float64", "bfloat16", "mixed", "transposed_dense", "strided_sparse",
    "too_many_features", "bad_shape", "grad_bfloat16", "grad_float64",
    "grad_on_cpu"])
def test_refuses_cuda_tensors_it_does_not_take(case):
    """The kernel takes float32 contiguous [B, D] and [B, F, D] tensors
    with F + 1 <= MAX_ROWS, and a float32 output gradient on their device;
    anything else on CUDA raises before a build or launch, and counts
    nothing."""
    def call():
        kw = dict(device="cuda")
        dense, sparse = torch.zeros(4, 8, **kw), torch.zeros(4, 3, 8, **kw)
        if case.startswith("grad_"):
            grad = {"grad_bfloat16": torch.zeros(4, 8 + 6, **kw).bfloat16(),
                    "grad_float64": torch.zeros(4, 8 + 6, **kw).double(),
                    "grad_on_cpu": torch.zeros(4, 8 + 6)}[case]
            return di.dot_interaction_backward(grad, dense, sparse)
        if case == "float64":
            dense, sparse = dense.double(), sparse.double()
        elif case == "bfloat16":
            dense, sparse = dense.bfloat16(), sparse.bfloat16()
        elif case == "mixed":
            dense = dense.double()
        elif case == "transposed_dense":
            dense = torch.zeros(8, 4, **kw).t()
        elif case == "strided_sparse":
            sparse = torch.empty_strided((4, 3, 8), (48, 16, 2), **kw)
        elif case == "too_many_features":
            sparse = torch.zeros(4, di.MAX_ROWS, 8, **kw)
        else:
            sparse = torch.zeros(4, 3, 7, **kw)
        return di.dot_interaction(dense, sparse)

    launches = tracing.counts()
    with pytest.raises((TypeError, ValueError)):
        _fake_cuda(call)
    assert tracing.counts() == launches


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cuda_tensors_never_take_the_plain_path(direction, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the build failing,
    the wrapper raises the build's error and does not take the plain
    version."""
    def fail(force=False):
        raise RuntimeError("nvcc failed (1): stand-in for a failed build")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(di.LIBRARY, "build", fail)
    monkeypatch.setattr(di.LIBRARY, "_lib", None)
    monkeypatch.setattr(di, "dot_interaction_reference", plain)
    monkeypatch.setattr(di, "dot_interaction_backward_reference", plain)

    def call():
        dense = torch.zeros(4, 8, device="cuda")
        sparse = torch.zeros(4, 3, 8, device="cuda")
        if direction == "forward":
            return di.dot_interaction_forward(dense, sparse)
        return di.dot_interaction_backward(
            torch.zeros(4, 8 + 6, device="cuda"), dense, sparse)

    launches = tracing.counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _fake_cuda(call)
    assert tracing.counts() == launches
