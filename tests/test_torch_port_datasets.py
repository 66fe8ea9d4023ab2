"""The port's datasets against the JAX package's, on the same numpy inputs.

The native TSV parser (csrc/criteo_parser.cpp, the port's copy) against
JAX's parser and the port's plain version; the binary utilities' npy
files byte for byte; the in-memory loader batch for batch (shuffled, at
rank 1 of 2, hashed, undersampled, memory-mapped, through the C++ stager
and the numpy route); the preproc CLIs; MovieLens; the splits; the host
streams of RandomRecDataset and SyntheticCriteoDataset bit for bit;
`device_latent_score` bit for bit on its edge ids; the card-side
generators, run on the CPU and held by their semantics (their draws are
torch's, not JAX's); and tests/test_synthetic_criteo.py's cases on the
port. A failed g++ build raises on the main path.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torchrec_tpu.datasets import criteo as jcriteo
from torchrec_tpu.datasets import movielens as jmovielens
from torchrec_tpu.datasets import random as jrandom
from torchrec_tpu.datasets import synthetic_criteo as jsynth
from torchrec_tpu.datasets import utils as jutils
from torchrec_tpu.datasets.scripts import (
    contiguous_preproc_criteo as jcontig,
    npy_preproc_criteo as jnpy,
)
from torchrec_tpu_torch.datasets import criteo, movielens
from torchrec_tpu_torch.datasets import utils as dutils
from torchrec_tpu_torch.datasets.random import RandomRecDataset, step_seed
from torchrec_tpu_torch.datasets.scripts import (
    contiguous_preproc_criteo,
    npy_preproc_criteo,
)
from torchrec_tpu_torch.datasets.synthetic_criteo import (
    CRITEO_KAGGLE_CARDINALITIES,
    SyntheticCriteoDataset,
    device_latent_score,
    latent_score,
    zipf_ids,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, D = criteo.CAT_FEATURE_COUNT, criteo.INT_FEATURE_COUNT


def _write_tsv(path, rows=40, seed=0, trailing_newline=True):
    """Criteo lines with empty fields, negative ints, upper- and
    lower-case hex, ids at and past 2^31 and a blank line."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        label = str(rng.randint(0, 2))
        dense = [str(rng.randint(-2, 1000)) for _ in range(D)]
        cats = ["%08x" % rng.randint(0, 2**31) for _ in range(F)]
        if i % 3 == 0:
            dense[2] = ""
            cats[5] = ""
            label = ""
        if i % 4 == 1:
            cats[0] = cats[0].upper()
            cats[1] = "ffffffff"
            cats[2] = "80000000"
            cats[3] = "1234567890ab"
        if i % 7 == 2:
            dense[12] = "-1"
        lines.append("\t".join([label] + dense + cats))
    lines.insert(rows // 2, "")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if trailing_newline else ""))


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("trailing_newline", [True, False])
def test_native_parser_matches_jax_and_the_plain_version(tmp_path,
                                                         trailing_newline):
    p = str(tmp_path / "day_0")
    _write_tsv(p, trailing_newline=trailing_newline)
    got = criteo.parse_criteo_tsv(p)
    _assert_same_arrays(got, criteo._parse_tsv_numpy(p))
    _assert_same_arrays(got, jcriteo.parse_criteo_tsv(p))
    _assert_same_arrays(got, jcriteo._parse_tsv_numpy(p))
    assert got[0].shape == (41, D)
    assert list(criteo.criteo_kaggle(p)) == list(jcriteo.criteo_kaggle(p))
    assert (list(criteo.criteo_terabyte([p, p]))
            == list(jcriteo.criteo_terabyte([p, p])))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _preprocessed_days(tmp, side, days=3, rows=30):
    """tsv_to_npys of `side` (the port's or JAX's utilities) over seeded
    day files: {day: (dense, sparse, labels) paths}."""
    raw = tmp / "raw"
    raw.mkdir(exist_ok=True)
    out = tmp / side.__name__.replace(".", "_")
    out.mkdir(exist_ok=True)
    paths = {}
    for d in range(days):
        src = raw / f"day_{d}"
        if not src.exists():
            _write_tsv(str(src), rows=rows, seed=d)
        paths[d] = tuple(str(out / f"day_{d}_{k}.npy")
                         for k in ("dense", "sparse", "labels"))
        side.BinaryCriteoUtils.tsv_to_npys(str(src), *paths[d])
    return paths


def test_binary_utils_write_jax_files(tmp_path):
    """tsv_to_npys, sparse_to_contiguous (thresholds 0, 2, 3) and shuffle
    write JAX's files byte for byte; the header reader, the rank split
    and the row-range loader (memory-mapped too) return JAX's values."""
    mine = _preprocessed_days(tmp_path, criteo)
    theirs = _preprocessed_days(tmp_path, jcriteo)
    for d in mine:
        for a, b in zip(mine[d], theirs[d]):
            assert _bytes(a) == _bytes(b)
            assert (criteo.BinaryCriteoUtils.get_shape_from_npy(a)
                    == jcriteo.BinaryCriteoUtils.get_shape_from_npy(b))
    sparse = [mine[d][1] for d in mine]
    for th in (0, 2, 3):
        for side, out in ((criteo, "c_port"), (jcriteo, "c_jax")):
            side.BinaryCriteoUtils.sparse_to_contiguous(
                sparse, str(tmp_path / f"{out}{th}"), frequency_threshold=th)
        for d in mine:
            name = f"day_{d}_sparse_contig_freq.npy"
            assert (_bytes(tmp_path / f"c_port{th}" / name)
                    == _bytes(tmp_path / f"c_jax{th}" / name))
    dense_dir = os.path.dirname(mine[0][0])
    for side, out in ((criteo, "s_port"), (jcriteo, "s_jax")):
        side.BinaryCriteoUtils.shuffle(dense_dir, dense_dir,
                                       str(tmp_path / out),
                                       {0: 31, 1: 30}, days=3, seed=5)
    for name in sorted(os.listdir(tmp_path / "s_jax")):
        assert (_bytes(tmp_path / "s_port" / name)
                == _bytes(tmp_path / "s_jax" / name)), name
    assert len(os.listdir(tmp_path / "s_port")) == 9
    for lengths, world in (([10, 20, 10], 2), ([7, 1, 5, 9], 3),
                           ([3], 4), ([5, 5], 1)):
        for rank in range(world):
            assert (criteo.BinaryCriteoUtils.get_file_idx_to_row_range(
                lengths, rank, world)
                == jcriteo.BinaryCriteoUtils.get_file_idx_to_row_range(
                    lengths, rank, world))
    for mmap in (False, True):
        got = criteo.BinaryCriteoUtils.load_npy_range(mine[1][1], 4, 9, mmap)
        want = jcriteo.BinaryCriteoUtils.load_npy_range(mine[1][1], 4, 9,
                                                        mmap)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for start, num in ((31, 1), (25, 10)):
        with pytest.raises(ValueError):
            criteo.BinaryCriteoUtils.load_npy_range(mine[1][1], start, num)


def _loader_files(tmp_path, n=600, days=2, dense_dtype=np.float32):
    rng = np.random.RandomState(0)
    paths = ([], [], [])
    for d in range(days):
        arrays = (rng.randn(n + 37 * d, D).astype(dense_dtype),
                  rng.randint(-3, 5000, (n + 37 * d, F)).astype(np.int32),
                  (rng.rand(n + 37 * d, 1) < 0.3).astype(np.int32))
        for out, kind, arr in zip(paths, ("dense", "sparse", "labels"),
                                  arrays):
            out.append(str(tmp_path / f"day_{d}_{kind}.npy"))
            np.save(out[-1], arr)
    return paths


LOADER_CASES = {
    "plain": {},
    "shuffle": {"shuffle_batches": True, "seed": 3},
    "rank1of2": {"rank": 1, "world_size": 2, "shuffle_batches": True},
    "hashes": {"hashes": [97 + 13 * f for f in range(F)]},
    "undersampling": {"undersampling_rate": 0.4, "shuffle_batches": True,
                      "seed": 1},
    "mmap": {"mmap_mode": True, "hashes": [1000] * F},
    "mmap_unhashed": {"mmap_mode": True},
}


@pytest.mark.parametrize("case", [*LOADER_CASES, "f64_dense",
                                  "numpy_route"])
def test_in_memory_loader_gives_jax_batches(tmp_path, case, monkeypatch):
    """Batch for batch JAX's (dense, ids, lengths, labels, keys), through
    the C++ stager where JAX's conditions allow it (the memory-mapped
    rows too, once concatenated in memory) and the numpy route otherwise
    (f64 dense rows, or the stager refused by hand)."""
    paths = _loader_files(tmp_path, dense_dtype=(
        np.float64 if case == "f64_dense" else np.float32))
    kw = {"batch_size": 64, **LOADER_CASES.get(case, {})}
    pipe = criteo.InMemoryBinaryCriteoIterDataPipe(*paths, **kw)
    want = list(jcriteo.InMemoryBinaryCriteoIterDataPipe(*paths, **kw))
    native = case not in ("f64_dense", "numpy_route")
    if case == "numpy_route":
        monkeypatch.setattr(pipe, "native_route", lambda: False)
    assert pipe.native_route() == native
    got = list(pipe)
    assert len(got) == len(want) == len(pipe) > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.dense_features.numpy(),
                                      w.dense_features)
        np.testing.assert_array_equal(g.sparse_features.ids.numpy(),
                                      w.sparse_features.ids)
        np.testing.assert_array_equal(g.sparse_features.lengths.numpy(),
                                      w.sparse_features.lengths)
        np.testing.assert_array_equal(g.labels.numpy(), w.labels)
        assert g.sparse_features.keys == w.sparse_features.keys
        assert g.sparse_features.ids.dtype == torch.int32
        assert g.labels.dtype == g.dense_features.dtype == torch.float32
        assert g.batch_size == 64


def test_native_parser_and_stager_raise_when_they_do_not_build(
        tmp_path, monkeypatch):
    """No silent numpy fallback: with g++ failing on the sources, the
    parser and the stager raise g++'s error on the main path, where JAX
    takes its numpy versions without a word."""
    from torchrec_tpu_torch.utils import native

    broken = tmp_path / "csrc"
    broken.mkdir()
    for src in ("criteo_parser.cpp", "batch_stager.cpp"):
        (broken / src).write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", broken / "_build")
    monkeypatch.setattr(criteo, "_LIBS", {})

    def plain(*args, **kwargs):
        raise AssertionError("the numpy version ran")

    monkeypatch.setattr(criteo, "_parse_tsv_numpy", plain)
    tsv = str(tmp_path / "day_0")
    _write_tsv(tsv, rows=5)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        criteo.parse_criteo_tsv(tsv)
    pipe = criteo.InMemoryBinaryCriteoIterDataPipe(
        *_loader_files(tmp_path), batch_size=64)
    assert pipe.native_route()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(iter(pipe))


def test_preproc_clis_write_jax_files(tmp_path):
    """Both CLIs, the port's through `python -m`, write JAX's files."""
    raw = tmp_path / "raw"
    raw.mkdir()
    for d in range(2):
        _write_tsv(str(raw / f"day_{d}"), rows=25, seed=d)
    outs = {}
    for side, npy, contig in (("port", npy_preproc_criteo,
                               contiguous_preproc_criteo),
                              ("jax", jnpy, jcontig)):
        o = tmp_path / side
        (o / "npy").mkdir(parents=True)
        if side == "port":
            env = dict(os.environ, PYTHONPATH=ROOT)
            subprocess.run(
                [sys.executable, "-m",
                 "torchrec_tpu_torch.datasets.scripts.npy_preproc_criteo",
                 "--input_dir", str(raw), "--output_dir", str(o / "npy")],
                check=True, capture_output=True, env=env, timeout=120)
        else:
            npy.main(["--input_dir", str(raw), "--output_dir",
                      str(o / "npy")])
        contig.main(["--input_dir", str(o / "npy"), "--output_dir",
                     str(o / "contig"), "--frequency_threshold", "2"])
        outs[side] = o
    for sub in ("npy", "contig"):
        names = sorted(os.listdir(outs["jax"] / sub))
        assert names == sorted(os.listdir(outs["port"] / sub))
        assert len(names) == (6 if sub == "npy" else 2)
        for name in names:
            assert (_bytes(outs["port"] / sub / name)
                    == _bytes(outs["jax"] / sub / name)), name


def test_movielens_pipes_and_splits(tmp_path):
    (tmp_path / "ratings.csv").write_text(
        "userId,movieId,rating,timestamp\n"
        "1,10,4.5,100\n2,20,3.0,200\n1,30,1.0,50\n")
    (tmp_path / "movies.csv").write_text(
        'movieId,title,genres\n10,"Toy Story, The",Animation|Comedy\n'
        "30,Heat,Action\n")
    for fn in ("movielens_20m", "movielens_25m"):
        for include in (False, True):
            got = list(getattr(movielens, fn)(str(tmp_path), include))
            assert got == list(getattr(jmovielens, fn)(str(tmp_path),
                                                       include))
            assert len(got) == 3
    assert list(movielens.movielens_25m(str(tmp_path), True))[1][
        "genres"] == ""
    items = list(range(300))
    for perc, seed in ((0.8, 0), (0.3, 7)):
        got = [list(x) for x in dutils.rand_split_train_val(items, perc,
                                                             seed)]
        want = [list(x) for x in jutils.rand_split_train_val(items, perc,
                                                             seed)]
        assert got == want and sorted(got[0] + got[1]) == items
    with pytest.raises(ValueError):
        dutils.rand_split_train_val(items, 1.0)
    fac = (lambda: iter([1, 2, 3]), lambda: iter([10, 20]))
    assert list(dutils.ParallelReadConcat(*fac)) == list(
        jutils.ParallelReadConcat(*fac))
    key = lambda i: i * 2654435761  # noqa: E731
    assert [dutils.train_filter(key, 0.7, 2, i) for i in range(50)] == [
        jutils.train_filter(key, 0.7, 2, i) for i in range(50)]
    assert [dutils.val_filter(key, 0.7, 2, i) for i in range(50)] == [
        jutils.val_filter(key, 0.7, 2, i) for i in range(50)]


def _same_batch(got, want):
    np.testing.assert_array_equal(got.dense_features.numpy(),
                                  np.asarray(want.dense_features))
    np.testing.assert_array_equal(got.sparse_features.ids.numpy(),
                                  np.asarray(want.sparse_features.ids))
    np.testing.assert_array_equal(got.sparse_features.lengths.numpy(),
                                  np.asarray(want.sparse_features.lengths))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert got.sparse_features.keys == tuple(want.sparse_features.keys)


@pytest.mark.parametrize("zipf_a", [None, 1.05, 1.0])
def test_random_rec_dataset_host_batches_are_jax(zipf_a):
    kw = dict(keys=["a", "b", "c"], batch_size=16, hash_sizes=[100, 50, 7],
              ids_per_feature=4, min_ids_per_feature=1, num_dense=5,
              num_batches=3, manual_seed=11, zipf_a=zipf_a)
    got, want = list(RandomRecDataset(**kw)), list(
        jrandom.RandomRecDataset(**kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_synthetic_criteo_host_batches_are_jax():
    for kw in ({"max_ind_range": 500}, {"zipf_a": 1.0, "manual_seed": 3}):
        ds = SyntheticCriteoDataset(batch_size=128, num_batches=2, **kw)
        jds = jsynth.SyntheticCriteoDataset(batch_size=128, num_batches=2,
                                            **kw)
        assert (ds.bias, ds.sigma, ds._z_mu, ds._z_sd) == (
            jds.bias, jds.sigma, jds._z_mu, jds._z_sd)
        for g, w in zip(ds, jds):
            _same_batch(g, w)
    rng, jrng = np.random.RandomState(4), np.random.RandomState(4)
    np.testing.assert_array_equal(zipf_ids(rng, 10131227, (300,)),
                                  jsynth.zipf_ids(jrng, 10131227, (300,)))


def test_device_latent_score_is_latent_score_bit_for_bit():
    """Edge ids (0, 2^31 - 1, each table's last row, negative ids,
    feature 25) and random ones, against numpy and JAX's twin."""
    last = np.asarray(CRITEO_KAGGLE_CARDINALITIES) - 1
    rng = np.random.RandomState(0)
    ids = np.concatenate([[0, 2**31 - 1, 1, 65535, 65536, -1, -2**31],
                          last, rng.randint(0, 2**31 - 1, 500)])
    feats = np.concatenate([[0, 25, 25, 3, 25, 7, 25], np.arange(26),
                            rng.randint(0, 26, 500)])
    want = latent_score(feats, ids)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(want, jsynth.latent_score(feats, ids))
    for dt in (torch.int32, torch.int64):
        got = device_latent_score(torch.from_numpy(feats).to(dt),
                                  torch.from_numpy(ids).to(dt)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    twin = np.asarray(jsynth.device_latent_score(
        jax.numpy.asarray(feats.astype(np.int32)),
        jax.numpy.asarray(ids.astype(np.int32))))
    np.testing.assert_array_equal(twin.view(np.uint32), want.view(np.uint32))


def _top_share(ids, k=100):
    counts = np.unique(ids, return_counts=True)[1]
    return np.sort(counts)[::-1][:k].sum() / len(ids), len(counts) / len(ids)


@pytest.mark.parametrize("zipf_a", [None, 1.05])
def test_random_rec_device_batches_on_the_cpu(zipf_a):
    """The card-side generator run on the CPU: shapes, dtypes, ids and
    lengths in range, moments, Zipf duplicates, reproducible from a seed."""
    hashes = [10_000, 50, 7]
    ds = RandomRecDataset(keys=["a", "b", "c"], batch_size=4096,
                          hash_sizes=hashes, ids_per_feature=3,
                          min_ids_per_feature=1, num_dense=6,
                          zipf_a=zipf_a, on_device=True, device="cpu",
                          num_batches=2)
    b, b2 = list(ds)
    gen = ds.device_batch_fn()
    again = gen(step_seed(0, 0))
    np.testing.assert_array_equal(again.sparse_features.ids,
                                  b.sparse_features.ids)
    np.testing.assert_array_equal(again.dense_features, b.dense_features)
    assert not torch.equal(b.dense_features, b2.dense_features)
    ids, lengths = b.sparse_features.ids, b.sparse_features.lengths
    assert ids.shape == (3, 4096, 3) and ids.dtype == torch.int32
    assert lengths.dtype == torch.int32
    assert int(lengths.min()) == 1 and int(lengths.max()) == 3
    for f, h in enumerate(hashes):
        assert 0 <= int(ids[f].min()) and int(ids[f].max()) < h
    dense = b.dense_features
    assert dense.shape == (4096, 6) and dense.dtype == torch.float32
    assert abs(float(dense.mean())) < 0.05
    assert abs(float(dense.std()) - 1.0) < 0.05
    assert abs(float(b.labels.mean()) - 0.5) < 0.05
    assert set(b.labels.unique().tolist()) <= {0.0, 1.0}
    share, unique = _top_share(ids[0].numpy().ravel())
    if zipf_a is None:
        assert share < 0.05 and unique > 0.4
    else:
        assert share > 0.25 and unique < 0.8
        counts = np.bincount(ids[2].numpy().ravel(), minlength=7)
        assert counts[0] == counts.max()


def test_synthetic_criteo_device_batches_on_the_cpu():
    """The card-side Criteo generator on the CPU, held by the bounds of
    tests/test_synthetic_criteo.py: ids in range, the Zipf head of the
    10M-row feature, the published CTR, dense moments equal to the host
    stream's, and labels drawn against the host ground truth's logits
    (its AUROC near the calibrated ceiling)."""
    from sklearn.metrics import roc_auc_score

    ds = SyntheticCriteoDataset(batch_size=8192)
    gen = ds.device_batch_fn("cpu")
    b = gen(step_seed(0))
    ids = b.sparse_features.ids[:, :, 0].numpy()
    assert b.sparse_features.ids.shape == (26, 8192, 1)
    assert ids.min() >= 0
    assert (ids.max(axis=1) < np.asarray(CRITEO_KAGGLE_CARDINALITIES)).all()
    share, unique = _top_share(ids[2])
    assert share > 0.25 and unique < 0.8
    labels = b.labels.numpy()
    assert abs(labels.mean() - 0.2562) < 0.03
    host = next(iter(SyntheticCriteoDataset(batch_size=8192,
                                            num_batches=1)))
    for stat in (np.mean, np.std):
        np.testing.assert_allclose(stat(b.dense_features.numpy(), axis=0),
                                   stat(host.dense_features.numpy(), axis=0),
                                   atol=0.06)
    lg = ds._logits(ids, b.dense_features.numpy())
    assert 0.73 < roc_auc_score(labels, lg) < 0.82
    np.testing.assert_array_equal(gen(step_seed(0)).labels.numpy(), labels)


# tests/test_synthetic_criteo.py's cases, on the port


def test_published_cardinalities():
    assert len(CRITEO_KAGGLE_CARDINALITIES) == 26
    assert max(CRITEO_KAGGLE_CARDINALITIES) == 10131227
    assert sum(CRITEO_KAGGLE_CARDINALITIES) == 33762577


def test_ctr_matches_published_rate():
    ds = SyntheticCriteoDataset(batch_size=4096, num_batches=8)
    labels = np.concatenate([b.labels.numpy() for b in ds])
    assert abs(labels.mean() - 0.2562) < 0.015, labels.mean()


def test_zipf_duplicate_structure():
    b = next(iter(SyntheticCriteoDataset(batch_size=8192, num_batches=1)))
    share, unique = _top_share(b.sparse_features.ids[2, :, 0].numpy())
    assert share > 0.25 and unique < 0.8


def test_zipf_ids_bounds():
    ids = zipf_ids(np.random.RandomState(0), 17, (10000,), a=1.05)
    assert ids.min() >= 0 and ids.max() < 17
    counts = np.bincount(ids, minlength=17)
    assert counts[0] == counts.max()


def test_ground_truth_bayes_auroc():
    from sklearn.metrics import roc_auc_score

    ds = SyntheticCriteoDataset(batch_size=8192, num_batches=4)
    labels, logits = [], []
    for b in ds:
        ids = b.sparse_features.ids[:, :, 0].numpy()
        labels.append(b.labels.numpy())
        logits.append(ds._logits(ids, b.dense_features.numpy()))
    got = roc_auc_score(np.concatenate(labels), np.concatenate(logits))
    assert 0.74 < got < 0.82, got


def test_max_ind_range_caps_ids():
    ds = SyntheticCriteoDataset(batch_size=1024, max_ind_range=5000,
                                num_batches=1)
    b = next(iter(ds))
    assert int(b.sparse_features.ids.max()) < 5000
    assert all(c <= 5000 for c in ds.cardinalities)
    dev = ds.device_batch_fn("cpu")(step_seed(1))
    assert int(dev.sparse_features.ids.max()) < 5000


def test_batch_to_and_args():
    b = next(iter(RandomRecDataset(keys=["a"], batch_size=4, hash_size=10,
                                   num_batches=1)))
    moved = b.to("cpu", non_blocking=True)
    dense, sb, labels = moved.batch_args()
    assert dense is not None and sb.keys == ("a",) and labels.shape == (4,)
    assert torch.equal(sb.ids, b.sparse_features.ids)
