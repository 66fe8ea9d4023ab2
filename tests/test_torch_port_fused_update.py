"""The port's fused embedding update against the JAX package, on the CPU.

K2-K5's plain versions (what the port's wrappers run on CPU tensors) are
held against the Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; the gradient prep and `apply_fused_update`
against the JAX functions, whose XLA route is what JAX takes on the CPU.
Inputs are made from a seed with numpy and handed to both sides.

Tolerances: row writes (K2) and the combined ids must match bit for bit.
Row updates differ by an ulp where XLA contracts a multiply and an add
into one fused operation (K3, K4), and sums run in another order (the
mean of g^2; duplicate ids combined per run here, per token in JAX's SGD
scatter-add): fp32 rows are held to rtol 1e-5 / atol 1e-6 and momentum to
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import fused_update_kernels as fk

R, D = 500, 128
LR = 0.05


def _t(a):
    return torch.as_tensor(np.array(a))


def _weights(seed=0):
    return np.random.RandomState(seed).randn(R, D).astype(np.float32)


def _raw_batch(n=300, seed=1):
    """Duplicate-rich ids with invalid slots, per-token gradients."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, R, size=n).astype(np.int32)
    ids[: n // 4] = rng.randint(0, 20, size=n // 4)  # hot rows repeat
    grads = rng.randn(n, D).astype(np.float32)
    valid = rng.rand(n) > 0.2
    return ids, grads, valid


def _unchanged_launches():
    return dict(fk.LAUNCHES)


def test_k2_scatter_rows_write_matches_pallas():
    rng = np.random.RandomState(2)
    w = _weights()
    real = rng.choice(R, size=150, replace=False).astype(np.int32)
    uids = np.concatenate([real, R + np.arange(40, dtype=np.int32),
                           np.full(10, 2**31 - 1, np.int32)])
    perm = rng.permutation(uids.shape[0])
    uids = uids[perm]
    rows = rng.randn(uids.shape[0], D).astype(np.float32)
    ref = np.asarray(pe.scatter_rows_write(
        jnp.asarray(w), jnp.asarray(uids), jnp.asarray(rows),
        interpret=True))
    before = _unchanged_launches()
    W = _t(w)
    out = fk.scatter_rows_write(W, _t(uids), _t(rows))
    assert out is W and fk.LAUNCHES == before  # in place, plain version
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k3_fused_update_sgd_matches_pallas(wd):
    ids, grads, valid = _raw_batch()
    uids, totals = jfu.run_total_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    uids, totals = np.asarray(uids), np.asarray(totals)
    assert (uids == 2**31 - 1).any()  # the sentinels sit between real slots
    w = _weights()
    ref = np.asarray(pe.fused_update_sgd(
        jnp.asarray(w), jnp.asarray(uids), jnp.asarray(totals), LR,
        weight_decay=wd, interpret=True))
    out = fk.fused_update_sgd(_t(w), _t(uids), _t(totals), LR,
                              weight_decay=wd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w_impl", ["rmw", "write"])
@pytest.mark.parametrize("stream", [False, True])
def test_k4_rowwise_adagrad_matches_pallas(stream, w_impl):
    ids, grads, valid = _raw_batch()
    uids, sums = jfu.dedup_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    uids, sums = np.asarray(uids), np.asarray(sums)
    w = _weights()
    m = np.random.RandomState(3).rand(R).astype(np.float32)
    ref_w, ref_m = pe.fused_update_rowwise_adagrad(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(uids), jnp.asarray(sums),
        LR, weight_decay=0.01, momentum_stream=stream, w_impl=w_impl,
        interpret=True)
    before = _unchanged_launches()
    W, M = _t(w), _t(m)
    out_w, out_m = fk.fused_update_rowwise_adagrad(
        W, M, _t(uids), _t(sums), LR, weight_decay=0.01,
        momentum_stream=stream, w_impl=w_impl)
    assert out_w is W and out_m is M and fk.LAUNCHES == before
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), rtol=1e-6)


@pytest.mark.parametrize("dups", [False, True])
def test_k5_rowwise_momentum_stream_matches_pallas(dups):
    rng = np.random.RandomState(4)
    Rm = 2500
    real = np.sort(rng.choice(Rm, size=300, replace=False)).astype(np.int32)
    gsq = rng.rand(300).astype(np.float32)
    if dups:
        # sorted with duplicates: repeated slots carry g_sq = 0
        rep = rng.randint(1, 4, size=300)
        gsq = np.concatenate([np.r_[g, np.zeros(k - 1, np.float32)]
                              for g, k in zip(gsq, rep)]).astype(np.float32)
        real = np.repeat(real, rep)
    n = real.shape[0]
    uids = np.concatenate([real, Rm + np.arange(n, n + 60, dtype=np.int32)])
    gsq = np.concatenate([gsq, np.zeros(60, np.float32)])
    m0 = rng.rand(Rm).astype(np.float32)
    ref_m, ref_inv, ovf = pe.rowwise_momentum_stream(
        jnp.asarray(m0), jnp.asarray(uids), jnp.asarray(gsq), eps=1e-8,
        interpret=True)
    assert not bool(ovf)
    before = _unchanged_launches()
    M = _t(m0)
    out_m, inv, overflowed = fk.rowwise_momentum_stream(
        M, _t(uids), _t(gsq), eps=1e-8)
    assert out_m is M and fk.LAUNCHES == before
    assert overflowed.dtype == torch.bool and not bool(overflowed)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv), rtol=1e-6)
    assert (inv.numpy()[n:] == 0).all()


@pytest.mark.parametrize("fn", ["dedup", "run_total"])
def test_grad_combine_matches_jax(fn):
    ids, grads, valid = _raw_batch()
    jf = {"dedup": jfu.dedup_row_grads,
          "run_total": jfu.run_total_row_grads}[fn]
    tf = {"dedup": tfu.dedup_row_grads,
          "run_total": tfu.run_total_row_grads}[fn]
    ref_u, ref_g = jf(jnp.asarray(ids), jnp.asarray(grads),
                      jnp.asarray(valid), R)
    uids, g = tf(_t(ids), _t(grads), _t(valid), R)
    assert uids.dtype == torch.int32
    np.testing.assert_array_equal(uids.numpy(), np.asarray(ref_u))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-6)
    if fn == "dedup":  # sorted and unique, real rows first
        u = uids.numpy()
        assert (np.diff(u) > 0).all()
        assert (u[u < R] == np.unique(ids[valid])).all()


@pytest.mark.parametrize("kind", ["sum", "mean_psw"])
def test_pooled_grad_to_row_grads_matches_jax(kind):
    rng = np.random.RandomState(5)
    F, B, L = 3, 6, 4
    d = rng.randn(F, B, D).astype(np.float32)
    lengths = rng.randint(0, L + 1, size=(F, B)).astype(np.int32)
    psw = rng.rand(F, B, L).astype(np.float32) if kind != "sum" else None
    mean = kind != "sum"
    ref = jfu.pooled_grad_to_row_grads(
        jnp.asarray(d), jnp.asarray(lengths), L, mean,
        None if psw is None else jnp.asarray(psw))
    out = tfu.pooled_grad_to_row_grads(
        _t(d), _t(lengths), L, mean, None if psw is None else _t(psw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("w_impl,mom_impl,wd", [
    ("auto", "auto", 0.0), ("write", "xla", 0.0), ("rmw", "stream", 0.01),
])
@pytest.mark.parametrize("optim", ["SGD", "EXACT_SGD", "ROWWISE_ADAGRAD"])
def test_apply_fused_update_matches_jax(optim, w_impl, mom_impl, wd):
    ids, grads, valid = _raw_batch(seed=6)
    w = _weights(seed=7)
    jopt = jfu.init_fused_optimizer_state(R, D, jfu.EmbOptimType[optim])
    topt = tfu.init_fused_optimizer_state(R, D, tfu.EmbOptimType[optim])
    if optim == "ROWWISE_ADAGRAD":
        m = np.random.RandomState(8).rand(R).astype(np.float32)
        jopt = jopt.replace(momentum1=jnp.asarray(m))
        topt.momentum1 = _t(m)
    ref_w, ref_opt = jfu.apply_fused_update(
        jnp.asarray(w), jopt, jnp.asarray(ids), jnp.asarray(grads),
        jnp.asarray(valid), 0.1, weight_decay=wd)
    W = _t(w)
    out_w, out_opt = tfu.apply_fused_update(
        W, topt, _t(ids), _t(grads), _t(valid), 0.1, weight_decay=wd,
        w_impl=w_impl, mom_impl=mom_impl)
    assert out_w is W and out_opt is topt and int(topt.step) == 1
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    if optim == "ROWWISE_ADAGRAD":
        np.testing.assert_allclose(topt.momentum1.numpy(),
                                   np.asarray(ref_opt.momentum1), rtol=1e-6)
    # rows no valid slot touched keep their bits
    untouched = np.setdiff1d(np.arange(R), ids[valid])
    np.testing.assert_array_equal(out_w.numpy()[untouched], w[untouched])


@pytest.mark.parametrize("bad", ["w_dtype", "uids_dtype", "g_rows",
                                 "g_width", "noncontig", "devices"])
def test_row_kernels_reject_bad_inputs(bad):
    w, uids, g = torch.zeros(10, 8), torch.zeros(4, dtype=torch.int32), \
        torch.zeros(4, 8)
    if bad == "w_dtype":
        w = w.double()
    elif bad == "uids_dtype":
        uids = uids.long()
    elif bad == "g_rows":
        g = torch.zeros(5, 8)
    elif bad == "g_width":
        g = torch.zeros(4, 4)
    elif bad == "noncontig":
        g = torch.zeros(8, 4).t()
    elif bad == "devices":
        w = w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fk.fused_update_sgd(w, uids, g, 0.1)


def test_apply_fused_update_rejects_unknown_impl():
    opt = tfu.init_fused_optimizer_state(R, D, tfu.EmbOptimType.EXACT_SGD)
    ids, grads, valid = _raw_batch(n=8)
    with pytest.raises(ValueError, match="w_impl"):
        tfu.apply_fused_update(_t(_weights()), opt, _t(ids), _t(grads),
                               _t(valid), 0.1, w_impl="scatter")
    assert int(opt.step) == 0
