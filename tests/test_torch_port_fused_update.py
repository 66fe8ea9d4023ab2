"""The port's fused embedding update against the JAX package, on the CPU.

K2-K7's plain versions (what the port's wrappers run on CPU tensors) are
held against the Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them; the gradient prep and `apply_fused_update`
against the JAX functions, whose XLA route is what JAX takes on the CPU.
Inputs are made from a seed with numpy and handed to both sides.

Tolerances: row writes (K2) and the combined ids must match bit for bit.
Row updates differ by an ulp where XLA contracts a multiply and an add
into one fused operation (K3, K4, K6, K7), and sums run in another order
(the mean of g^2; duplicate ids combined per run here, per token in JAX's
SGD scatter-add): fp32 rows are held to rtol 1e-5 / atol 1e-6 and
momentum to rtol 1e-6 (atol 1e-7 for the full momenta, whose elements
reach zero). Against `apply_fused_update`'s XLA route, which adds a
delta where the kernels write the new value and divides by 1 - b**t where
K7 multiplies by its inverse: ADAM's rows rtol 1e-4 / atol 1e-6, as
tests/test_pallas.py holds the two JAX routes to each other; LAMB,
PARTIAL_ROWWISE_LAMB and LARS_SGD, whose per-row norms sum D terms in
another order, rtol 1e-4 / atol 1e-6; ADAGRAD and PARTIAL_ROWWISE_ADAM
rtol 1e-5 / atol 1e-6. Momenta take the same tolerance as their rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.utils import tracing

R, D = 500, 128
LR = 0.05


def _t(a):
    return torch.as_tensor(np.array(a))


def _weights(seed=0, dim=D):
    return np.random.RandomState(seed).randn(R, dim).astype(np.float32)


def _raw_batch(n=300, seed=1, dim=D):
    """Duplicate-rich ids with invalid slots, per-token gradients."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, R, size=n).astype(np.int32)
    ids[: n // 4] = rng.randint(0, 20, size=n // 4)  # hot rows repeat
    grads = rng.randn(n, dim).astype(np.float32)
    valid = rng.rand(n) > 0.2
    return ids, grads, valid


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
    before = tracing.counts()
    W = _t(w)
    out = fk.scatter_rows_write(W, _t(uids), _t(rows))
    assert out is W and tracing.counts() == before  # in place, plain version
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


def _lane_order_mean_sq(g):
    """The fused kernel's g_sq in numpy float32, lane by lane: lane l sums
    ((x*x + y*y) + z*z) + w*w of float4 c * 32 + l over the 128-column
    chunks c in order, a xor butterfly over 16, 8, 4, 2, 1 combines the 32
    lanes, and the total is divided by D."""
    N, dim = g.shape
    part = np.zeros((N, 32), np.float32)
    for c in range(-(-dim // 128)):
        for lane in range(32):
            k = (c * 32 + lane) * 4
            if k < dim:
                x, y, z, w = (g[:, k + i] for i in range(4))
                part[:, lane] += ((x * x + y * y) + z * z) + w * w
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ off]
    assert (part == part[:, :1]).all()  # every lane holds the same total
    return part[:, 0] / np.float32(dim)


@pytest.mark.parametrize("dim", [64, 128, 256])
def test_row_mean_sq_sums_in_the_kernels_order(dim):
    rng = np.random.RandomState(12)
    g = (rng.randn(40, dim) * np.exp(rng.randn(40, 1) * 3)).astype(np.float32)
    out = fk.row_mean_sq(_t(g))
    assert out.dtype == torch.float32 and out.shape == (40,)
    np.testing.assert_array_equal(out.numpy(), _lane_order_mean_sq(g))
    np.testing.assert_allclose(
        out.numpy(), (g.astype(np.float64) ** 2).mean(axis=1), rtol=1e-6)


# (momentum_stream, w_impl, D, weight decay); the first four ids are the
# routes at D = 128, the rest the default route the fused kernel takes
K4_CASES = [
    pytest.param(False, "rmw", D, 0.01, id="False-rmw"),
    pytest.param(True, "rmw", D, 0.01, id="True-rmw"),
    pytest.param(False, "write", D, 0.01, id="False-write"),
    pytest.param(True, "write", D, 0.01, id="True-write"),
    pytest.param(True, "rmw", 64, 0.0, id="fused-D64-wd0"),
    pytest.param(True, "rmw", 64, 0.01, id="fused-D64-wd0.01"),
    pytest.param(True, "rmw", 256, 0.0, id="fused-D256-wd0"),
    pytest.param(True, "rmw", 256, 0.01, id="fused-D256-wd0.01"),
]


@pytest.mark.parametrize("stream,w_impl,dim,wd", K4_CASES)
def test_k4_rowwise_adagrad_matches_pallas(stream, w_impl, dim, wd):
    ids, grads, valid = _raw_batch(dim=dim)
    uids, sums = jfu.dedup_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    uids, sums = np.asarray(uids), np.asarray(sums)
    w = _weights(dim=dim)
    m = np.random.RandomState(3).rand(R).astype(np.float32)
    ref_w, ref_m = pe.fused_update_rowwise_adagrad(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(uids), jnp.asarray(sums),
        LR, weight_decay=wd, momentum_stream=stream, w_impl=w_impl,
        interpret=True)
    before = tracing.counts()
    W, M = _t(w), _t(m)
    out_w, out_m = fk.fused_update_rowwise_adagrad(
        W, M, _t(uids), _t(sums), LR, weight_decay=wd,
        momentum_stream=stream, w_impl=w_impl)
    assert out_w is W and out_m is M and tracing.counts() == before
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), rtol=1e-6)


def test_fused_slots_per_warp():
    """One slot per warp at BERT4Rec's training shape, two at the DLRM's,
    never more than a warp's 32 lanes."""
    got = {n: fk.fused_slots_per_warp(n)
           for n in (1, 2048, 65535, 65536, 212_992, 262_144, 2**31 - 1)}
    assert got == {1: 1, 2048: 1, 65535: 1, 65536: 2, 212_992: 2,
                   262_144: 4, 2**31 - 1: 32}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k4_routes_agree_on_momentum(wd):
    """Every route sums g_sq in row_mean_sq's order, so the four routes
    (K5 or torch index ops x scaled RMW or K2) leave the same momentum bit
    for bit; the rows agree bit for bit between the two row writes, and
    within an ulp of the scale between the two momentum routes (lr * inv
    against -lr / (...), as JAX's two routes round)."""
    ids, grads, valid = _raw_batch(seed=13)
    uids, sums = tfu.dedup_row_grads(_t(ids), _t(grads), _t(valid), R)
    w = _weights(seed=14)
    m = np.random.RandomState(15).rand(R).astype(np.float32)
    out = {}
    for stream in (True, False):
        for w_impl in ("rmw", "write"):
            W, M = _t(w), _t(m)
            fk.fused_update_rowwise_adagrad(
                W, M, uids, sums, LR, weight_decay=wd,
                momentum_stream=stream, w_impl=w_impl)
            out[stream, w_impl] = (W.numpy(), M.numpy())
    ref_w, ref_m = out[True, "rmw"]
    assert not np.array_equal(ref_m, m)
    for (stream, w_impl), (got_w, got_m) in out.items():
        np.testing.assert_array_equal(got_m, ref_m)
        np.testing.assert_array_equal(got_w, out[stream, "rmw"][0])
        np.testing.assert_allclose(got_w, ref_w, rtol=1e-6, atol=1e-7)


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
    before = tracing.counts()
    M = _t(m0)
    out_m, inv, overflowed = fk.rowwise_momentum_stream(
        M, _t(uids), _t(gsq), eps=1e-8)
    assert out_m is M and tracing.counts() == before
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


SENTINEL = 2**31 - 1


def _run_totals(seed=1):
    """Run-total inputs of K6 / K7 from JAX's `run_total_row_grads`."""
    ids, grads, valid = _raw_batch(seed=seed)
    uids, totals = jfu.run_total_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    uids, totals = np.asarray(uids), np.asarray(totals)
    assert (uids == SENTINEL).any()  # the sentinels sit between real slots
    return uids, totals


def _assert_untouched(outs, before, uids):
    untouched = np.setdiff1d(np.arange(R), uids[uids < R])
    for out, b in zip(outs, before):
        np.testing.assert_array_equal(out.numpy()[untouched], b[untouched])


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k6_fused_update_adagrad_matches_pallas(wd):
    uids, totals = _run_totals()
    w = _weights()
    m = np.random.RandomState(3).rand(R, D).astype(np.float32)
    ref_w, ref_m = pe.fused_update_adagrad(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(uids),
        jnp.asarray(totals), LR, weight_decay=wd, interpret=True)
    before = tracing.counts()
    W, M = _t(w), _t(m)
    out_w, out_m = fk.fused_update_adagrad(W, M, _t(uids), _t(totals), LR,
                                           weight_decay=wd)
    assert out_w is W and out_m is M and tracing.counts() == before
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), rtol=1e-6,
                               atol=1e-7)
    _assert_untouched((out_w, out_m), (w, m), uids)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_k7_fused_update_adam_matches_pallas(wd):
    uids, totals = _run_totals()
    w = _weights()
    rng = np.random.RandomState(3)
    m1 = (rng.randn(R, D) * 0.01).astype(np.float32)
    m2 = (rng.rand(R, D) * 0.01).astype(np.float32)
    step = 6  # the incremented step: bias corrections far from 1
    ref_w, ref_m1, ref_m2 = pe.fused_update_adam(
        jnp.asarray(w), jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(uids),
        jnp.asarray(totals), LR, jnp.asarray(step, jnp.int32),
        weight_decay=wd, interpret=True)
    before = tracing.counts()
    W, M1, M2 = _t(w), _t(m1), _t(m2)
    out = fk.fused_update_adam(W, M1, M2, _t(uids), _t(totals), LR,
                               torch.tensor(step, dtype=torch.int32),
                               weight_decay=wd)
    assert out[0] is W and out[1] is M1 and out[2] is M2
    assert tracing.counts() == before
    np.testing.assert_allclose(W.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    for got, ref in ((M1, ref_m1), (M2, ref_m2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)
    _assert_untouched((W, M1, M2), (w, m1, m2), uids)


def test_adam_bias_correction_rounds_as_jax():
    """The f32 bias corrections agree with the Pallas wrapper's, and the
    1 - beta constants are rounded once from double (JAX's weak typing),
    not formed from f32 beta: the two differ for beta2 = 0.999."""
    for t in (1, 2, 6, 1000):
        bc = fk.adam_bias_correction(torch.tensor(t, dtype=torch.int32),
                                     0.9, 0.999)
        tf = jnp.float32(t)
        ref = np.array([1.0 / (1.0 - 0.9**tf), 1.0 / (1.0 - 0.999**tf)],
                       np.float32)
        assert bc.dtype == torch.float32 and bc.shape == (2,)
        np.testing.assert_allclose(bc.numpy(), ref, rtol=1e-6)
    assert np.float32(1.0 - 0.999) != np.float32(1) - np.float32(0.999)
    g = torch.ones(1, 1)
    _, _, m2 = fk.adam_rows(g, g * 0, g * 0, g, 0.0, torch.ones(2), 1e-8, 0.0,
                            0.9, 0.999)
    assert m2.item() == np.float32(1.0 - 0.999)


@pytest.mark.parametrize("optim", ["ADAGRAD", "ADAM"])
def test_full_momentum_write_matches_rmw(optim):
    """The gather + K2 write form of ADAGRAD / ADAM against the K6 / K7
    form through `apply_fused_update`, as tests/test_pallas.py holds the
    JAX package's two forms."""
    ids, grads, valid = _raw_batch(seed=9)
    w = _weights(seed=10)
    rng = np.random.RandomState(11)
    outs = {}
    m = {k: rng.rand(R, D).astype(np.float32) for k in ("m1", "m2")}
    for impl in ("rmw", "write"):
        opt = tfu.init_fused_optimizer_state(R, D, tfu.EmbOptimType[optim])
        opt.momentum1 = _t(m["m1"])
        if opt.momentum2 is not None:
            opt.momentum2 = _t(m["m2"])
        opt.step.fill_(3)
        W = _t(w)
        tfu.apply_fused_update(W, opt, _t(ids), _t(grads), _t(valid), 0.05,
                               weight_decay=0.01, w_impl=impl)
        assert int(opt.step) == 4
        outs[impl] = (W, opt)
    (w_r, o_r), (w_w, o_w) = outs["rmw"], outs["write"]
    np.testing.assert_allclose(w_w.numpy(), w_r.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(o_w.momentum1.numpy(), o_r.momentum1.numpy(),
                               rtol=1e-6, atol=1e-7)
    if o_r.momentum2 is not None:
        np.testing.assert_allclose(o_w.momentum2.numpy(),
                                   o_r.momentum2.numpy(), rtol=1e-6,
                                   atol=1e-7)


NEW_OPTIMS = {  # optimizer -> (rtol, atol) of rows and momenta
    "ADAGRAD": (1e-5, 1e-6),
    "ADAM": (1e-4, 1e-6),
    "PARTIAL_ROWWISE_ADAM": (1e-5, 1e-6),
    "LAMB": (1e-4, 1e-6),
    "PARTIAL_ROWWISE_LAMB": (1e-4, 1e-6),
    "LARS_SGD": (1e-4, 1e-6),
}


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("optim", sorted(NEW_OPTIMS))
def test_apply_fused_update_full_state_matches_jax(optim, wd):
    ids, grads, valid = _raw_batch(seed=6)
    w = _weights(seed=7)
    rng = np.random.RandomState(8)
    jopt = jfu.init_fused_optimizer_state(R, D, jfu.EmbOptimType[optim])
    topt = tfu.init_fused_optimizer_state(R, D, tfu.EmbOptimType[optim])
    start = {}
    for name in ("momentum1", "momentum2"):
        m = getattr(topt, name)
        if m is not None:
            start[name] = (rng.rand(*m.shape) * 0.1).astype(np.float32)
            setattr(topt, name, _t(start[name]))
    jopt = jopt.replace(step=jnp.asarray(4, jnp.int32),
                        **{k: jnp.asarray(v) for k, v in start.items()})
    topt.step.fill_(4)
    ref_w, ref_opt = jfu.apply_fused_update(
        jnp.asarray(w), jopt, jnp.asarray(ids), jnp.asarray(grads),
        jnp.asarray(valid), 0.1, weight_decay=wd)
    before = tracing.counts()
    W = _t(w)
    out_w, out_opt = tfu.apply_fused_update(
        W, topt, _t(ids), _t(grads), _t(valid), 0.1, weight_decay=wd)
    assert out_w is W and out_opt is topt and int(topt.step) == 5
    assert tracing.counts() == before
    rtol, atol = NEW_OPTIMS[optim]
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), rtol=rtol,
                               atol=atol)
    for name, m0 in start.items():
        np.testing.assert_allclose(
            getattr(topt, name).numpy(), np.asarray(getattr(ref_opt, name)),
            rtol=rtol, atol=atol, err_msg=name)
    # rows and momenta no valid slot touched keep their bits
    untouched = np.setdiff1d(np.arange(R), ids[valid])
    np.testing.assert_array_equal(out_w.numpy()[untouched], w[untouched])
    for name, m0 in start.items():
        np.testing.assert_array_equal(
            getattr(topt, name).numpy()[untouched], m0[untouched])


@pytest.mark.parametrize("bad", ["m_rows", "m_width", "m_dtype", "step_dev"])
def test_moment_kernels_reject_bad_inputs(bad):
    w, uids, g = torch.zeros(10, 8), torch.zeros(4, dtype=torch.int32), \
        torch.zeros(4, 8)
    m1, m2, step = torch.zeros(10, 8), torch.zeros(10, 8), torch.tensor(1)
    if bad == "m_rows":
        m2 = torch.zeros(9, 8)
    elif bad == "m_width":
        m1 = torch.zeros(10, 4)
    elif bad == "m_dtype":
        m2 = m2.double()
    else:
        step = step.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fk.fused_update_adam(w, m1, m2, uids, g, 0.1, step)
    if bad != "step_dev":
        with pytest.raises((TypeError, ValueError)):
            fk.fused_update_adagrad(w, m1 if bad == "m_width" else m2, uids,
                                    g, 0.1)
