"""The port's quantization against the JAX package, on the CPU.

The same numpy tables and ids go through torchrec_tpu/ops/quant.py, the
JAX QuantEmbeddingBagCollection and ShardedQuantEmbeddingBagCollection,
and their counterparts in the port (Kq's plain version: the tensors lie
on the CPU). Tolerances: quantized bytes, scales and shifts, dequantized
rows and one-slot pooling bit for bit; several slots per bag within rtol
1e-6, since only the order of the sums differs (the port adds the slots
in order, JAX's einsum in its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops import quant as jq
from torchrec_tpu.ops.embedding import PoolingMode as JMode
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel.quant_sharded import (
    ShardedQuantEmbeddingBagCollection as JSQEBC,
)
from torchrec_tpu.quant import QuantEmbeddingBagCollection as JQEBC
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules import EmbeddingBagConfig, PoolingType
from torchrec_tpu_torch.modules.embedding_configs import (
    DATA_TYPE_NUM_BITS,
    DataType,
)
from torchrec_tpu_torch.ops import quant as tq
from torchrec_tpu_torch.ops import quant_lookup as ql
from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.parallel import ShardingEnv
from torchrec_tpu_torch.parallel.quant_sharded import (
    ShardedQuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

BITS = [8, 4, 2]
R, D = 200, 16


def _weights(seed, rows=R, dim=D):
    """Random rows, one constant row (scale 1.0) and one whose range
    1.0005 / 255 rounds in fp16 (and in the 4- and 2-bit steps)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(rows, dim).astype(np.float32)
    w[3] = 0.25
    w[5] = np.linspace(-0.3, 0.7005, dim, dtype=np.float32)
    return w


def _pair(bits, seed=0):
    w = _weights(seed)
    return (jq.quantize_rowwise(jnp.asarray(w), bits),
            tq.quantize_rowwise(torch.from_numpy(w), bits))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_rowwise_of_a_half_table_matches_jax(bits, dtype):
    """A half table's min, max and range are taken in its dtype, as JAX
    takes them: the bf16 row [0, 1, 0, 0] at int8 has scale
    0.003936767578125 (1/255 rounded to bf16, then fp16) and stores 1.0
    as 254. Random rows bit for bit at every width."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    one = np.asarray([[0, 1, 0, 0]], np.float32)
    rows = np.concatenate([one, _weights(4)[:, :4]])
    j = jq.quantize_rowwise(jnp.asarray(rows).astype(jdt), bits)
    t = tq.quantize_rowwise(torch.from_numpy(rows).to(tdt), bits)
    for part in ("data", "scale", "shift"):
        np.testing.assert_array_equal(getattr(t, part).numpy(),
                                      np.asarray(getattr(j, part)))
    if bits == 8 and dtype == "bfloat16":
        assert t.scale[0].item() == 0.003936767578125
        assert t.data[0].tolist() == [0, 254, 0, 0]


@pytest.mark.parametrize("bits", BITS)
def test_quantize_rowwise_matches_jax_bit_for_bit(bits):
    j, t = _pair(bits)
    for part in ("data", "scale", "shift"):
        np.testing.assert_array_equal(getattr(t, part).numpy(),
                                      np.asarray(getattr(j, part)))
    assert (t.bits, t.dim) == (j.bits, j.dim) == (bits, D)
    assert t.data.dtype == torch.uint8
    assert t.scale[3].item() == 1.0  # the constant row
    # the fp16 rounding of the range is not the identity on row 5
    rng = float(np.ptp(_weights(0)[5]))
    assert t.scale[5].item() != np.float32(rng / ((1 << bits) - 1))


def test_quantize_packing_shapes_and_sizes():
    w = torch.ones((4, 16))
    assert tuple(tq.quantize_rowwise(w, 8).data.shape) == (4, 16)
    assert tuple(tq.quantize_rowwise(w, 4).data.shape) == (4, 8)
    assert tuple(tq.quantize_rowwise(w, 2).data.shape) == (4, 4)
    assert tq.quantized_size_bytes(100, 128, 4) == jq.quantized_size_bytes(
        100, 128, 4) == 100 * (64 + 8)
    with pytest.raises(ValueError):
        tq.quantize_rowwise(w, 3)
    with pytest.raises(ValueError):
        tq.quantize_rowwise(torch.ones((4, 6)), 2)
    assert {k.value: v for k, v in DATA_TYPE_NUM_BITS.items()} == {
        "FP32": 32, "FP16": 16, "BF16": 16, "INT8": 8, "INT4": 4, "INT2": 2}


@pytest.mark.parametrize("bits", BITS)
def test_dequantize_rows_matches_jax_bit_for_bit(bits):
    j, t = _pair(bits)
    ids = np.concatenate([np.arange(R), [R, R + 7]]).astype(np.int32)
    want = np.asarray(jq.dequantize_rows(j, jnp.asarray(ids)))
    got = tq.dequantize_rows(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # dequantized within half a step (plus the fp16 shift) of the floats
    w = _weights(0)
    step = (w.max(1) - w.min(1)) / ((1 << bits) - 1)
    err = np.abs(got[:R].numpy() - w).max(1)
    assert (err <= 0.51 * step + 1e-2).all()


def test_negative_id_clamps_to_row_zero_where_jax_wraps():
    """A deliberate difference (ROADMAP section 3): Kq clamps a negative id
    to row 0, as the port's K1 does; JAX's gather wraps it numpy-style.
    An id >= R reads row R-1 on both sides."""
    j, t = _pair(8)
    ids = np.asarray([-1, -R, R + 3], np.int32)
    want = np.asarray(jq.dequantize_rows(j, jnp.asarray(ids)))
    got = tq.dequantize_rows(t, torch.from_numpy(ids)).numpy()
    rows = tq.dequantize_rows(t, torch.tensor([0, R - 1])).numpy()
    np.testing.assert_array_equal(got[0], rows[0])
    np.testing.assert_array_equal(got[1], rows[0])
    np.testing.assert_array_equal(got[2], rows[1])
    np.testing.assert_array_equal(want[0], rows[1])  # JAX: row R-1
    np.testing.assert_array_equal(want[1], rows[0])
    np.testing.assert_array_equal(want[2], rows[1])


def _bags(seed, F, B, L, rows=R, zero=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, rows, size=(F, B, L)).astype(np.int32)
    lengths = rng.randint(0 if zero else 1, L + 1, size=(F, B)).astype(
        np.int32)
    psw = rng.rand(F, B, L).astype(np.float32)
    return ids, lengths, psw


@pytest.mark.parametrize("bits", BITS)
def test_pooled_lookup_one_slot_matches_jax_bit_for_bit(bits):
    j, t = _pair(bits, seed=1)
    ids, lengths, psw = _bags(2, 3, 7, 1)
    for weights in (None, psw):
        want = jq.quant_embedding_bag_lookup(
            j, jnp.asarray(ids), jnp.asarray(lengths), JMode.SUM,
            None if weights is None else jnp.asarray(weights))
        got = tq.quant_embedding_bag_lookup(
            t, torch.from_numpy(ids), torch.from_numpy(lengths),
            PoolingMode.SUM,
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pooling", ["SUM", "MEAN"])
@pytest.mark.parametrize("bits", BITS)
def test_pooled_lookup_many_slots_matches_jax(bits, pooling):
    """L=5 with per-sample weights and zero lengths: rtol 1e-6."""
    j, t = _pair(bits, seed=3)
    ids, lengths, psw = _bags(4, 2, 9, 5)
    want = jq.quant_embedding_bag_lookup(
        j, jnp.asarray(ids), jnp.asarray(lengths), JMode[pooling],
        jnp.asarray(psw))
    got = tq.quant_embedding_bag_lookup(
        t, torch.from_numpy(ids), torch.from_numpy(lengths),
        PoolingMode[pooling], torch.from_numpy(psw))
    assert (lengths == 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bits", BITS)
def test_unpooled_lookup_matches_jax_bit_for_bit(bits):
    j, t = _pair(bits, seed=5)
    ids, lengths, psw = _bags(6, 2, 4, 3)
    want = jq.quant_embedding_bag_lookup(
        j, jnp.asarray(ids), jnp.asarray(lengths), JMode.NONE,
        jnp.asarray(psw))
    got = tq.quant_embedding_bag_lookup(
        t, torch.from_numpy(ids), torch.from_numpy(lengths),
        PoolingMode.NONE, torch.from_numpy(psw))
    assert tuple(got.shape) == (2, 4, 3, D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", BITS)
def test_plain_kq_sums_the_slots_in_order(bits):
    """The plain version is the kernel's arithmetic: q * scale rounded,
    + shift rounded, then coeff * row added to a zero sum slot by slot,
    each step rounded to f32 (a numpy spelling of it, bit for bit)."""
    _, t = _pair(bits, seed=7)
    rng = np.random.RandomState(8)
    ids = rng.randint(-3, R + 3, size=(11, 6)).astype(np.int32)
    coeff = (rng.rand(11, 6) * (rng.rand(11, 6) > 0.3)).astype(np.float32)
    got = ql.quant_lookup_pooled(t.data, t.scale, t.shift,
                                 torch.from_numpy(ids),
                                 torch.from_numpy(coeff), bits)
    per_byte = 8 // bits
    data = t.data.numpy()
    q = np.stack([(data >> (bits * k)) & ((1 << bits) - 1)
                  for k in range(per_byte)], -1).reshape(R, D)
    rows = (q.astype(np.float32) * t.scale.numpy()[:, None]
            + t.shift.numpy()[:, None])
    want = np.zeros((11, D), np.float32)
    for slot in range(6):
        r = rows[np.clip(ids[:, slot], 0, R - 1)]
        want = want + coeff[:, slot, None] * r
    np.testing.assert_array_equal(got.numpy(), want)


def _tables(pooling_mean=True, rows=(50, 30, 40), dim=16):
    out = []
    for i, r in enumerate(rows):
        feats = ["f1", "f2"] if i == 1 else [f"f{3 if i == 2 else 0}"]
        out.append(dict(num_embeddings=r, embedding_dim=dim, name=f"q{i}",
                        feature_names=feats,
                        pooling="MEAN" if pooling_mean and i == 2
                        else "SUM"))
    return out


def _configs(args):
    j = tuple(JConfig(**{**a, "pooling": JPooling[a["pooling"]]})
              for a in args)
    t = [EmbeddingBagConfig(**{**a, "pooling": PoolingType[a["pooling"]]})
         for a in args]
    return j, t


def _kjt_pair(args, B, L, seed, weighted=False):
    rng = np.random.RandomState(seed)
    feats = [f for a in args for f in a["feature_names"]]
    rows = {f: a["num_embeddings"] for a in args for f in a["feature_names"]}
    lengths = rng.randint(0, L + 1, size=len(feats) * B).astype(np.int32)
    vals = np.concatenate(
        [rng.randint(0, rows[feats[i // B]], size=lengths[i])
         for i in range(len(lengths))] + [np.zeros(0)]).astype(np.int32)
    w = rng.rand(len(vals)).astype(np.float32) if weighted else None
    jk = JKJT.from_lengths(feats, jnp.asarray(vals), jnp.asarray(lengths),
                           weights=None if w is None else jnp.asarray(w))
    tk = KeyedJaggedTensor.from_lengths(feats, vals, lengths, weights=w)
    return jk, tk


@pytest.mark.parametrize("weighted", [False, True])
def test_quant_ebc_from_float_matches_jax(weighted):
    args = _tables()
    jt, tt = _configs(args)
    rng = np.random.RandomState(9)
    weights = {a["name"]: rng.randn(a["num_embeddings"], 16).astype(
        np.float32) for a in args}
    L = 3
    jk, tk = _kjt_pair(args, 12, L, seed=10, weighted=weighted)
    jq_ebc = JQEBC.from_float(jt, weights, is_weighted=weighted,
                              max_feature_length=L)
    tq_ebc = QuantEmbeddingBagCollection.from_float(
        tt, weights, DataType.INT8, is_weighted=weighted,
        max_feature_length=L, device="cpu")
    want = jq_ebc(jk)
    got = tq_ebc(tk)
    assert tuple(got.keys) == tuple(want.keys)
    assert tuple(got.length_per_key) == tuple(want.length_per_key)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-6)
    for name, q in tq_ebc.quantized.items():
        np.testing.assert_array_equal(q.data.numpy(),
                                      np.asarray(jq_ebc.quantized[name].data))


def _sharded_pair(bits=8, weighted=False):
    args = _tables()
    jt, tt = _configs(args)
    rng = np.random.RandomState(11)
    weights = {a["name"]: rng.randn(a["num_embeddings"], 16).astype(
        np.float32) for a in args}
    dt = {8: DataType.INT8, 4: DataType.INT4}[bits]
    jdt = {8: jq_types().INT8, 4: jq_types().INT4}[bits]
    L = 2
    j = JSQEBC.from_float(JEnv.from_devices(jax.devices()[:1]), jt, weights,
                          jdt, is_weighted=weighted, max_feature_length=L)
    t = ShardedQuantEmbeddingBagCollection.from_float(
        ShardingEnv("cpu"), tt, weights, dt, is_weighted=weighted,
        max_feature_length=L)
    ju = JQEBC.from_float(jt, weights, jdt, is_weighted=weighted,
                          max_feature_length=L)
    tu = QuantEmbeddingBagCollection.from_float(
        tt, weights, dt, is_weighted=weighted, max_feature_length=L,
        device="cpu")
    return args, (j, t), (ju, tu)


def jq_types():
    from torchrec_tpu.modules.embedding_configs import DataType as JDataType

    return JDataType


@pytest.mark.parametrize("bits,weighted", [(8, False), (8, True),
                                           (4, True)])
def test_sharded_quant_ebc_matches_jax(bits, weighted):
    """SUM and MEAN tables, weighted input, on a one-device JAX mesh: the
    packed group (JAX's one device's) and each feature's row offset bit
    for bit, the pooled output within rtol 1e-6."""
    args, (j, t), _ = _sharded_pair(bits, weighted)
    for part in ("data", "scale", "shift"):
        np.testing.assert_array_equal(getattr(t, part).numpy(),
                                      np.asarray(getattr(j, part))[0])
    assert t.data.shape[0] == j.rows_max
    np.testing.assert_array_equal(t.feat_rowoff.numpy(),
                                  j.dev_feat_rowoff[0][j.out_pos])
    jk, tk = _kjt_pair(args, 16, 2, seed=12, weighted=weighted)
    want, got = j(jk), t(tk)
    assert tuple(got.keys) == tuple(want.keys)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-6)


def test_sharded_quant_ebc_tables_round_trip():
    """`quantized` of the sharded module gives back each table's rows."""
    _, (_, t), (_, tu) = _sharded_pair(4)
    for name, q in tu.quantized.items():
        got = t.quantized[name]
        for part in ("data", "scale", "shift"):
            assert torch.equal(getattr(got, part), getattr(q, part))
        assert (got.bits, got.dim) == (q.bits, q.dim)


def test_sharded_and_unsharded_mean_orders_differ():
    """The JAX docstring calls the sharded output bit-identical to the
    unsharded one; that holds for SUM only. For MEAN the unsharded module
    divides the pooled sum and the sharded one folds 1 / length into the
    coefficient first (ROADMAP section 3). Both packages show it, and the
    port follows each module's own order: each port module equals its JAX
    counterpart within rtol 1e-6 and SUM columns agree bit for bit."""
    args, (j, t), (ju, tu) = _sharded_pair(8)
    jk, tk = _kjt_pair(args, 256, 7, seed=13)
    jk, tk = jk.to_padded(7), tk.to_padded(7)  # past max_feature_length
    js, jun = np.asarray(j(jk).values), np.asarray(ju(jk).values)
    ts, tun = t(tk).values.numpy(), tu(tk).values.numpy()
    mean_cols = slice(3 * 16, 4 * 16)  # f3, the MEAN table's feature
    for s, u in ((js, jun), (ts, tun)):
        np.testing.assert_array_equal(s[:, :mean_cols.start],
                                      u[:, :mean_cols.start])
        assert (s[:, mean_cols] != u[:, mean_cols]).any()
        np.testing.assert_allclose(s, u, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tun, jun, rtol=1e-6, atol=1e-6)


def test_sharded_quant_ebc_refuses_several_devices():
    """Over two devices the module places tables round-robin (rank 0 packs
    tables 0 and 2 only) and refuses a placement on a device outside the
    world, as JAX's does."""
    class TwoDevices:
        world_size, rank, device = 2, 0, torch.device("cpu")

    _, tt = _configs(_tables())
    q = {c.name: tq.quantize_rowwise(torch.ones(c.num_embeddings, 16))
         for c in tt}
    sq = ShardedQuantEmbeddingBagCollection(TwoDevices(), tt, q)
    assert set(sq.quantized) == {tt[0].name, tt[2].name}
    with pytest.raises(ValueError, match="outside"):
        ShardedQuantEmbeddingBagCollection(
            TwoDevices(), tt, q, {c.name: 2 for c in tt})


def test_quant_ebc_refuses_float_types_and_unpooled_tables():
    _, tt = _configs(_tables())
    w = {c.name: np.ones((c.num_embeddings, 16), np.float32) for c in tt}
    with pytest.raises(ValueError, match="not a quantized type"):
        QuantEmbeddingBagCollection.from_float(tt, w, DataType.FP16,
                                               device="cpu")
    none = [EmbeddingBagConfig(num_embeddings=4, embedding_dim=16, name="n",
                               feature_names=["f"],
                               pooling=PoolingType.NONE)]
    with pytest.raises(ValueError, match="SUM or MEAN"):
        QuantEmbeddingBagCollection.from_float(
            none, {"n": np.ones((4, 16), np.float32)}, device="cpu")
