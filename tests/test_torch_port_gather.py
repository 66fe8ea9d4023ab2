"""K8 (the row gather), the routed gather of the sharded sequence path,
the gradients of K1 and K8, and the unpooled lookups of the port against
the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both sides. K8's
plain version is held against the Pallas kernel in interpret mode (as
tests/test_pallas.py:35,41 run it), bit for bit: a gather is a copy. The
gradients of the port's autograd Functions are held against `jax.vjp` of
the Pallas functions in interpret mode at rtol = atol = 1e-6: the
scatter-adds of duplicate ids and the dot products of d_coeff sum in
another order (K8's against the Pallas function's VJP rule, called
directly: `jax.vjp` of it raises, see the test). The unpooled lookups go
against the JAX package's XLA path (its CPU route): fp32 exactly, bf16 at
rtol = atol = 1e-2. On CPU tensors no kernel is launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingConfig as JSeqConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops import embedding as jemb
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.sharded_ec import (
    ShardedEmbeddingCollection as JSEC,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops import embedding as temb
from torchrec_tpu_torch.ops import gather_rows as gr
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing

R = 60
GRAD_TOL = dict(rtol=1e-6, atol=1e-6)


def _ids(rng, shape, lo=-R - 3, hi=R + 7):
    """Ids past both ends: the forward clips them, the backward drops the
    ones outside [-R, R-1] and wraps [-R, -1]."""
    return rng.randint(lo, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("N,T", [(300, 256), (37, 16), (1, 16), (0, 16)])
@pytest.mark.parametrize("D", [16, 13])
def test_k8_matches_pallas_interpret(N, T, D):
    rng = np.random.RandomState(N + D)
    w = rng.randn(R, D).astype(np.float32)
    ids = _ids(rng, (N,))
    launches = tracing.counts()
    out = gr.gather_rows(torch.as_tensor(w), torch.as_tensor(ids))
    assert tracing.counts() == launches  # CPU tensors take the plain version
    assert out.shape == (N, D) and out.dtype == torch.float32
    if N:
        ref = np.asarray(pe.gather_rows(jnp.asarray(w), jnp.asarray(ids), T,
                                        True))
        np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), gr.gather_rows_reference(
            torch.as_tensor(w), torch.as_tensor(ids)).numpy())


@pytest.mark.parametrize(
    "bad", ["w_dtype", "ids_dtype", "ids_2d", "noncontig", "no_rows"])
def test_k8_wrapper_rejects_bad_inputs(bad):
    w = torch.zeros(10, 8)
    ids = torch.zeros(4, dtype=torch.int32)
    if bad == "w_dtype":
        w = w.double()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_2d":
        ids = ids.reshape(2, 2)
    elif bad == "noncontig":
        w = torch.zeros(8, 10).t()
    else:
        w = torch.zeros(0, 8)
    with pytest.raises((TypeError, ValueError)):
        gr.gather_rows(w, ids)


@pytest.mark.parametrize("N", [200, 37])
def test_k8_gradient_matches_jax_vjp(N):
    rng = np.random.RandomState(N)
    D = 16
    w = rng.randn(R, D).astype(np.float32)
    ids = _ids(rng, (N,))
    d_rows = rng.randn(N, D).astype(np.float32)
    # the Pallas function's own VJP rule: jax.vjp of pe.gather_rows raises
    # under jax 0.9 (its fwd rule saves weights.shape and .dtype, which
    # are not JAX types, as residuals), so the rule is called directly
    with pytest.raises(TypeError):
        jax.vjp(lambda ww: pe.gather_rows(ww, jnp.asarray(ids), 16, True),
                jnp.asarray(w))
    jd_w, _ = pe._gather_rows_bwd(
        16, True, ((R, D), jnp.float32, jnp.asarray(ids)),
        jnp.asarray(d_rows))

    tw = torch.tensor(w, requires_grad=True)
    out = gr.gather_rows(tw, torch.as_tensor(ids))
    out.backward(torch.as_tensor(d_rows))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jd_w), **GRAD_TOL)
    # the drop/wrap semantics, spelled out: [-1, 5, 2] on 4 rows
    d = gr.scatter_add_rows(4, torch.tensor([-1, 5, 2], dtype=torch.int32),
                            torch.ones(3, 1))
    assert d[:, 0].tolist() == [0.0, 0.0, 1.0, 1.0]


def _k1_inputs(L, kind, seed):
    rng = np.random.RandomState(seed)
    NB, D = 24, 16
    w = rng.randn(R, D).astype(np.float32)
    ids = _ids(rng, (NB, L))
    lengths = rng.randint(0, L + 1, size=(NB,))
    valid = np.arange(L)[None, :] < lengths[:, None]
    if kind == "mean":
        coeff = valid / np.maximum(lengths, 1)[:, None]
    else:  # per-sample weights
        coeff = valid * rng.rand(NB, L)
    d_out = rng.randn(NB, D).astype(np.float32)
    return w, ids, coeff.astype(np.float32), d_out


@pytest.mark.parametrize("kind", ["mean", "psw"])
@pytest.mark.parametrize("L", [1, 4])
def test_k1_gradient_matches_jax_vjp(L, kind):
    w, ids, coeff, d_out = _k1_inputs(L, kind, seed=3 * L)
    _, vjp = jax.vjp(
        lambda ww, cc: pe.tbe_lookup_pooled(ww, jnp.asarray(ids), cc, True),
        jnp.asarray(w), jnp.asarray(coeff))
    jd_w, jd_coeff = vjp(jnp.asarray(d_out))

    tw = torch.tensor(w, requires_grad=True)
    tc = torch.tensor(coeff, requires_grad=True)
    launches = tracing.counts()
    out = tl.tbe_lookup_pooled(tw, torch.as_tensor(ids), tc)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(d_out))
    assert tracing.counts() == launches
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jd_w), **GRAD_TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jd_coeff),
                               **GRAD_TOL)


def test_k1_gradient_only_where_asked():
    w, ids, coeff, d_out = _k1_inputs(3, "psw", seed=1)
    tc = torch.tensor(coeff, requires_grad=True)
    tl.tbe_lookup_pooled(torch.as_tensor(w), torch.as_tensor(ids),
                         tc).backward(torch.as_tensor(d_out))
    assert tc.grad is not None and tc.grad.shape == coeff.shape
    tw = torch.tensor(w, requires_grad=True)
    tl.tbe_lookup_pooled(tw, torch.as_tensor(ids),
                         torch.as_tensor(coeff)).backward(
        torch.as_tensor(d_out))
    assert tw.grad is not None and tw.grad.shape == w.shape


def _lookup_inputs(dtype, weighted, F=None, seed=1):
    rng = np.random.RandomState(seed)
    B, L, D = 8, 5, 16
    lead = (B,) if F is None else (F, B)
    w = rng.randn(R, D).astype(np.float32)
    ids = rng.randint(0, R, size=lead + (L,)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=lead).astype(np.int32)
    psw = rng.rand(*lead, L).astype(np.float32) if weighted else None
    jw = jnp.asarray(w, dtype=jnp.bfloat16 if dtype == "bf16" else None)
    tw = torch.as_tensor(w)
    if dtype == "bf16":
        tw = tw.to(torch.bfloat16)
    return jw, tw, ids, lengths, psw


def _check(out, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "bf16":
        assert out.dtype == torch.bfloat16  # the table's dtype, as in JAX
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2,
                                   atol=1e-2)
    else:
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lookup_rows_matches_jax(dtype):
    jw, tw, ids, _, _ = _lookup_inputs(dtype, False)
    flat = ids.reshape(-1)
    _check(temb.lookup_rows(tw, torch.as_tensor(flat)),
           jemb.lookup_rows(jw, jnp.asarray(flat)), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_unpooled_embedding_bag_lookup_matches_jax(weighted, dtype):
    jw, tw, ids, lengths, psw = _lookup_inputs(dtype, weighted)
    ref = jemb.embedding_bag_lookup(
        jw, jnp.asarray(ids), jnp.asarray(lengths), jemb.PoolingMode.NONE,
        None if psw is None else jnp.asarray(psw))
    out = temb.embedding_bag_lookup(
        tw, torch.as_tensor(ids), torch.as_tensor(lengths),
        temb.PoolingMode.NONE,
        None if psw is None else torch.as_tensor(psw))
    assert out.shape == ids.shape + (16,)
    _check(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["batched", "sequence"])
def test_unpooled_batched_lookups_match_jax(fn, dtype):
    F = 3
    jw, tw, ids, lengths, _ = _lookup_inputs(dtype, False, F=F)
    ids = ids % 20  # three tables of 20 rows in one array
    offs = [0, 20, 40]
    args_j = (jw, jnp.asarray(ids), jnp.asarray(lengths),
              jnp.asarray(offs, jnp.int32))
    args_t = (tw, torch.as_tensor(ids), torch.as_tensor(lengths), offs)
    if fn == "batched":
        ref = jemb.batched_embedding_lookup(*args_j, jemb.PoolingMode.NONE)
        out = temb.batched_embedding_lookup(*args_t, temb.PoolingMode.NONE)
    else:
        ref = jemb.sequence_embedding_lookup(*args_j)
        out = temb.sequence_embedding_lookup(*args_t)
    assert out.shape == ids.shape + (16,)
    _check(out, ref, dtype)
    # pad tokens are zero rows
    pad = np.arange(ids.shape[2])[None, None, :] >= lengths[:, :, None]
    assert not out.float().numpy()[pad].any()


@pytest.mark.parametrize("pooling", ["SUM", "MEAN"])
def test_unsharded_ebc_gradient_matches_jax(pooling):
    """d_table and d_per_sample_weights through the weighted EBC: K1's
    Function (CPU plain version) against JAX autodiff of its module."""
    L, B, D = 4, 8, 16
    rng = np.random.RandomState(5)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    ids = rng.randint(0, R, size=int(lengths.sum())).astype(np.int32)
    psw = rng.rand(ids.shape[0]).astype(np.float32)
    w = rng.randn(R, D).astype(np.float32)
    cot = rng.randn(B, D).astype(np.float32)

    jebc = JEBC(tables=(JConfig(num_embeddings=R, embedding_dim=D,
                                name="t", feature_names=["f"],
                                pooling=JPooling[pooling]),),
                is_weighted=True, max_feature_length=L)

    def jloss(ww, pw):
        sb = JKJT.from_lengths(["f"], jnp.asarray(ids), jnp.asarray(lengths),
                               pw).to_padded(L)
        return (jebc.apply({"params": {"t": ww}}, sb).values * cot).sum()

    jd_w, jd_psw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w),
                                                  jnp.asarray(psw))

    ebc = EmbeddingBagCollection(
        [EmbeddingBagConfig(num_embeddings=R, embedding_dim=D, name="t",
                            feature_names=["f"],
                            pooling=PoolingType[pooling])],
        is_weighted=True, max_feature_length=L, device="cpu")
    with torch.no_grad():
        ebc.embedding_bags["t"].copy_(torch.as_tensor(w))
    tpsw = torch.tensor(psw, requires_grad=True)
    out = ebc(KeyedJaggedTensor.from_lengths(["f"], ids, lengths, tpsw))
    (out.values * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(ebc.embedding_bags["t"].grad.numpy(),
                               np.asarray(jd_w), **GRAD_TOL)
    np.testing.assert_allclose(tpsw.grad.numpy(), np.asarray(jd_psw),
                               **GRAD_TOL)


# -- the routed gather of the sharded sequence path --------------------------


def _routed_inputs(seed, B=4, L=6, D=8):
    """A JAX row-wise sequence strategy over two devices of the CPU mesh
    (tables of 37 rows, features a and b, and 20 rows, feature c: F = 3,
    shard rows 19 and 10), one device's packed shard, and ids [3, B, L]
    with negative ids, ids >= 2 x shard rows and ids under padding."""
    tables = (JSeqConfig(num_embeddings=37, embedding_dim=D, name="t0",
                         feature_names=["a", "b"]),
              JSeqConfig(num_embeddings=20, embedding_dim=D, name="t1",
                         feature_names=["c"]))
    jsec = JSEC(JEnv.from_devices(jax.devices()[:2]), tables,
                {t.name: JPS(JST.ROW_WISE) for t in tables})
    strat = jsec.strategies[0]
    rng = np.random.RandomState(seed)
    w = rng.randn(strat.rows_loc, D).astype(np.float32)
    ids = rng.randint(-45, 60, size=(3, B, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(3, B)).astype(np.int32)
    return strat, w, ids, lengths


def _port_route_args(strat, ids, lengths, my):
    return (torch.as_tensor(ids), torch.as_tensor(lengths),
            torch.as_tensor(strat.feat_shard_rows, dtype=torch.int32),
            torch.as_tensor(strat.feat_local_off, dtype=torch.int32), my)


@pytest.mark.parametrize("my", [0, 1])
def test_routed_gather_matches_jax_route_and_pallas_gather(my):
    """JAX's `_route`, the Pallas gather (interpret mode) and the mask
    multiply against the plain version, and the wrapper on CPU tensors.
    Rows are compared by value: JAX multiplies a masked row by 0, which
    leaves -0.0 under negative entries, where the port writes +0.0.
    `local` and `owned` are compared bit for bit."""
    strat, w, ids, lengths = _routed_inputs(seed=10 + my)
    L = ids.shape[2]
    local, owned = strat._route(jnp.asarray(ids), jnp.asarray(lengths), my, L)
    rows = pe.gather_rows(jnp.asarray(w), local.reshape(-1), 16, True)
    ref = np.asarray(rows.reshape(*ids.shape, -1)
                     * owned.astype(jnp.float32)[..., None])
    local, owned = np.asarray(local), np.asarray(owned)
    assert owned.any() and not owned.all()
    assert ((ids < 0) & (np.arange(L) < lengths[..., None])).any()

    args = _port_route_args(strat, ids, lengths, my)
    launches = tracing.counts()
    tw = torch.as_tensor(w)
    for out in (gr.routed_gather_rows_reference(tw, *args),
                gr.routed_gather_rows(tw, *args)):
        assert out.shape == ids.shape + (w.shape[1],)
        np.testing.assert_array_equal(out.numpy(), ref)
    for t_local, t_owned in (gr.route_tokens_reference(*args),
                             gr.route_tokens(*args)):
        assert t_local.dtype == torch.int32 and t_owned.dtype == torch.bool
        np.testing.assert_array_equal(t_local.numpy(), local)
        np.testing.assert_array_equal(t_owned.numpy(), owned)
    # CPU tensors take the plain versions
    assert tracing.counts() == launches


def test_routed_gather_gives_zeros_under_a_non_finite_masked_row():
    """The deliberate difference: a masked token whose row is NaN gives
    zeros here, NaN in JAX's multiply by the mask."""
    strat, w, ids, lengths = _routed_inputs(seed=3)
    ids[:] = 5  # owned on rank 0, masked under padding
    lengths[:] = 2
    w[[5, 24]] = np.nan  # local rows 5 (t0) and 19 + 5 (t1)
    args = _port_route_args(strat, ids, lengths, 0)
    out = gr.routed_gather_rows_reference(torch.as_tensor(w), *args).numpy()
    assert np.isnan(out[:, :, :2]).all()
    np.testing.assert_array_equal(out[:, :, 2:], 0.0)
    jref = np.asarray(pe.gather_rows(jnp.asarray(w), jnp.asarray(
        ids.reshape(-1)), 16, True)).reshape(out.shape) * 0.0
    assert np.isnan(jref).all()


@pytest.mark.parametrize(
    "bad", ["ids_dtype", "ids_2d", "lengths_shape", "offsets_dtype",
            "noncontig", "w_dtype"])
def test_routed_gather_rejects_bad_inputs(bad):
    w = torch.zeros(10, 8)
    ids = torch.zeros(2, 3, 4, dtype=torch.int32)
    lengths = torch.zeros(2, 3, dtype=torch.int32)
    sr = torch.full((2,), 5, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_2d":
        ids = ids.reshape(6, 4)
    elif bad == "lengths_shape":
        lengths = lengths.t().contiguous()
    elif bad == "offsets_dtype":
        off = off.long()
    elif bad == "noncontig":
        ids = torch.zeros(2, 4, 3, dtype=torch.int32).transpose(1, 2)
    else:
        w = w.double()
    with pytest.raises((TypeError, ValueError)):
        gr.routed_gather_rows(w, ids, lengths, sr, off, 0)
    if bad != "w_dtype":
        with pytest.raises((TypeError, ValueError)):
            gr.route_tokens(ids, lengths, sr, off, 0)
