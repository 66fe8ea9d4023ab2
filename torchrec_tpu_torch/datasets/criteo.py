"""Criteo (1TB Click Logs / Kaggle DAC) dataset support.

Counterpart of torchrec_tpu/datasets/criteo.py: the streaming TSV pipes,
the binary preprocessing utilities (`BinaryCriteoUtils`, whose npy files
are byte for byte JAX's) and the per-rank in-memory loader
(`InMemoryBinaryCriteoIterDataPipe`).

Two C++ sources of the port's csrc/ do the host's heavy work, built with
g++ by utils/native.py and loaded through ctypes:

* csrc/criteo_parser.cpp parses a TSV on several threads
  (`parse_criteo_tsv`); `_parse_tsv_numpy` is its plain version.
* csrc/batch_stager.cpp copies a batch's rows and transposes the ids to
  the [F, B, 1] layout in one pass. With `pin_memory=True` it
  writes into pinned host tensors, a new set a batch, so that the train
  pipeline copies them to the card as they are and an in-flight copy is
  never overwritten.

Where JAX falls back to numpy without a word when g++ fails, the port
chooses the route by its arguments alone, under JAX's conditions (a
memory-mapped array, or a dtype or layout the stager does not take, goes
the numpy way), and a failed build raises with g++'s output.

A batch's ids are int32 with lengths of one, the dtype the port's
PaddedSparseBatch and its lookup kernel take, so nothing converts them
in the step.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils.native import build_native_lib

INT_FEATURE_COUNT = 13
CAT_FEATURE_COUNT = 26
DAYS = 24
FREQUENCY_THRESHOLD = 3
TOTAL_TRAINING_SAMPLES = 4_195_197_692  # days 0-22

DEFAULT_LABEL_NAME = "label"
DEFAULT_INT_NAMES: List[str] = [f"int_{i}" for i in range(INT_FEATURE_COUNT)]
DEFAULT_CAT_NAMES: List[str] = [f"cat_{i}" for i in range(CAT_FEATURE_COUNT)]
DEFAULT_COLUMN_NAMES: List[str] = [
    DEFAULT_LABEL_NAME, *DEFAULT_INT_NAMES, *DEFAULT_CAT_NAMES
]

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_i32p = ctypes.POINTER(ctypes.c_int32)

# ---------------------------------------------------------------------------
# The native libraries, built on first use
# ---------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def _load(src: str, bind) -> ctypes.CDLL:
    with _LIBS_LOCK:
        if src not in _LIBS:
            lib = build_native_lib(src)
            bind(lib)
            _LIBS[src] = lib
    return _LIBS[src]


def _bind_parser(lib: ctypes.CDLL) -> None:
    lib.count_lines.restype = ctypes.c_int64
    lib.count_lines.argtypes = [ctypes.c_char_p]
    lib.parse_criteo_tsv.restype = ctypes.c_int64
    lib.parse_criteo_tsv.argtypes = [
        ctypes.c_char_p, _c_i32p, _c_i32p, _c_i32p, ctypes.c_int64,
        ctypes.c_int32]


def _bind_stager(lib: ctypes.CDLL) -> None:
    lib.stage_batch.restype = None
    lib.stage_batch.argtypes = [
        _c_f32p,          # dense_in
        _c_i32p,          # sparse_in
        _c_i32p,          # labels_in
        ctypes.c_int64,   # start
        ctypes.c_int64,   # batch
        ctypes.c_int32,   # dense_dim
        ctypes.c_int32,   # num_feats
        _c_f32p,          # dense_out
        _c_i32p,          # sparse_out
        _c_f32p,          # labels_out
    ]


def _native_parser() -> ctypes.CDLL:
    """Build (once) and load csrc/criteo_parser.cpp; raises with g++'s
    output if the build fails."""
    return _load("criteo_parser.cpp", _bind_parser)


def _native_stager() -> ctypes.CDLL:
    """Build (once) and load csrc/batch_stager.cpp; raises with g++'s
    output if the build fails."""
    return _load("batch_stager.cpp", _bind_stager)


# ---------------------------------------------------------------------------
# TSV parsing
# ---------------------------------------------------------------------------


def _parse_tsv_numpy(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The parser's plain version: a Python loop over the lines."""
    dense, sparse, labels = [], [], []
    with open(path, "r") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            cols += [""] * (1 + INT_FEATURE_COUNT + CAT_FEATURE_COUNT
                            - len(cols))
            labels.append(int(cols[0] or 0))
            dense.append(
                [int(cols[i] or 0) for i in range(1, 1 + INT_FEATURE_COUNT)]
            )
            sparse.append(
                [
                    int(cols[i] or "0", 16)
                    for i in range(
                        1 + INT_FEATURE_COUNT,
                        1 + INT_FEATURE_COUNT + CAT_FEATURE_COUNT,
                    )
                ]
            )
    return (
        np.asarray(dense, dtype=np.int64).astype(np.int32),
        np.asarray(sparse, dtype=np.int64).astype(np.int32),
        np.asarray(labels, dtype=np.int32),
    )


def parse_criteo_tsv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (dense [N, 13] int32 raw, sparse [N, 26] int32, labels [N] int32)
    through the native parser."""
    lib = _native_parser()
    n = lib.count_lines(path.encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    dense = np.zeros((n, INT_FEATURE_COUNT), np.int32)
    sparse = np.zeros((n, CAT_FEATURE_COUNT), np.int32)
    labels = np.zeros((n,), np.int32)
    got = lib.parse_criteo_tsv(
        path.encode(),
        dense.ctypes.data_as(_c_i32p),
        sparse.ctypes.data_as(_c_i32p),
        labels.ctypes.data_as(_c_i32p),
        n,
        os.cpu_count() or 4,
    )
    if got != n:
        raise IOError(f"parsed {got} of {n} rows from {path}")
    return dense, sparse, labels


# ---------------------------------------------------------------------------
# Streaming TSV pipes
# ---------------------------------------------------------------------------


def criteo_tsv_reader(paths: Sequence[str]) -> Iterator[Dict]:
    """Stream example dicts from raw TSVs (terabyte or kaggle format)."""
    for path in paths:
        with open(path, "r") as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                cols += [""] * (len(DEFAULT_COLUMN_NAMES) - len(cols))
                out: Dict = {DEFAULT_LABEL_NAME: int(cols[0] or 0)}
                for i, name in enumerate(DEFAULT_INT_NAMES):
                    out[name] = int(cols[1 + i] or 0)
                for i, name in enumerate(DEFAULT_CAT_NAMES):
                    out[name] = int(cols[1 + INT_FEATURE_COUNT + i] or "0", 16)
                yield out


def criteo_terabyte(paths: Sequence[str]) -> Iterator[Dict]:
    """The 1TB Click Logs' day files."""
    return criteo_tsv_reader(paths)


def criteo_kaggle(path: str) -> Iterator[Dict]:
    """The Kaggle train.txt, which shares the terabyte format."""
    return criteo_tsv_reader([path])


# ---------------------------------------------------------------------------
# Binary preprocessing
# ---------------------------------------------------------------------------


class BinaryCriteoUtils:
    """npy preprocessing utilities."""

    @staticmethod
    def tsv_to_npys(
        in_file: str,
        out_dense_file: str,
        out_sparse_file: str,
        out_labels_file: str,
    ) -> None:
        """TSV -> (dense f32 log(x+3), sparse int32, labels int32 [N, 1])
        npys, through the native parser."""
        dense, sparse, labels = parse_criteo_tsv(in_file)
        dense_f = np.log(dense.astype(np.float32) + 3.0, dtype=np.float32)
        np.save(out_dense_file, dense_f)
        np.save(out_sparse_file, sparse)
        np.save(out_labels_file, labels.reshape(-1, 1))

    @staticmethod
    def get_shape_from_npy(path: str) -> Tuple[int, ...]:
        """Shape from the npy header only."""
        with open(path, "rb") as fin:
            np.lib.format.read_magic(fin)
            shape, _order, _dtype = np.lib.format.read_array_header_1_0(fin)
            return shape

    @staticmethod
    def get_file_idx_to_row_range(
        lengths: Sequence[int], rank: int, world_size: int
    ) -> Dict[int, Tuple[int, int]]:
        """This rank's contiguous global row range, spanning files:
        {file_idx: (start, end)}, inclusive ends, in file-local rows. The
        last rank takes the remainder."""
        total = sum(lengths)
        rows_per_rank = total // world_size
        start = rank * rows_per_rank
        end = (rank + 1) * rows_per_rank - 1
        if rank == world_size - 1:
            end = total - 1
        out: Dict[int, Tuple[int, int]] = {}
        file_start = 0
        for idx, length in enumerate(lengths):
            file_end = file_start + length - 1
            lo = max(start, file_start)
            hi = min(end, file_end)
            if lo <= hi:
                out[idx] = (lo - file_start, hi - file_start)
            file_start += length
        return out

    @staticmethod
    def load_npy_range(
        fname: str, start_row: int, num_rows: int, mmap_mode: bool = False
    ) -> np.ndarray:
        """Load a row range of a 2-D npy (a memory map's view with
        `mmap_mode`)."""
        if mmap_mode:
            data = np.load(fname, mmap_mode="r")
            return data[start_row : start_row + num_rows]
        with open(fname, "rb") as fin:
            np.lib.format.read_magic(fin)
            shape, _order, dtype = np.lib.format.read_array_header_1_0(fin)
            if len(shape) != 2:
                raise ValueError("load_npy_range requires ndim == 2")
            total_rows, row_size = shape
            if not 0 <= start_row < total_rows:
                raise ValueError(f"start_row {start_row} out of bounds")
            if start_row + num_rows > total_rows:
                raise ValueError("num_rows exceeds available rows")
            fin.seek(start_row * row_size * dtype.itemsize, os.SEEK_CUR)
            data = np.fromfile(fin, dtype=dtype, count=num_rows * row_size)
            return data.reshape(num_rows, row_size)

    @staticmethod
    def sparse_to_contiguous(
        in_files: Sequence[str],
        output_dir: str,
        frequency_threshold: int = FREQUENCY_THRESHOLD,
        columns: int = CAT_FEATURE_COUNT,
        output_file_suffix: str = "_contig_freq.npy",
    ) -> None:
        """Re-index each column's categorical ids to contiguous ints across
        all files: ids seen fewer than `frequency_threshold` times map to
        1, the others to 2, 3, ... in order of first appearance."""
        arrays = {
            os.path.basename(f).split(".")[0]: np.load(f) for f in in_files
        }
        names = list(arrays.keys())
        for col in range(columns):
            concat = np.concatenate([arrays[n][:, col] for n in names])
            if frequency_threshold > 1:
                uniq, counts = np.unique(concat, return_counts=True)
                freq_of = dict(zip(uniq.tolist(), counts.tolist()))
            _, first_idx = np.unique(concat, return_index=True)
            appearance_order = concat[np.sort(first_idx)]
            mapping: Dict[int, int] = {}
            running = 2
            for v in appearance_order.tolist():
                if frequency_threshold > 1 and freq_of[v] < frequency_threshold:
                    mapping[v] = 1
                else:
                    mapping[v] = running
                    running += 1
            keys = np.asarray(sorted(mapping.keys()))
            vals = np.asarray([mapping[k] for k in keys.tolist()], np.int32)
            for n in names:
                idx = np.searchsorted(keys, arrays[n][:, col])
                arrays[n][:, col] = vals[idx]
        os.makedirs(output_dir, exist_ok=True)
        for n, arr in arrays.items():
            np.save(os.path.join(output_dir, n + output_file_suffix), arr)

    @staticmethod
    def shuffle(
        input_dir_labels_and_dense: str,
        input_dir_sparse: str,
        output_dir_shuffled: str,
        rows_per_day: Dict[int, int],
        days: int = DAYS,
        seed: int = 0,
    ) -> None:
        """Shuffle the training days' rows together into per-day npys
        (`np.random.RandomState(seed).permutation`); day `days - 1` (the
        test day) passes through."""
        train_days = days - 1
        dense_parts, sparse_parts, label_parts = [], [], []
        for d in range(train_days):
            dense_parts.append(np.load(os.path.join(
                input_dir_labels_and_dense, f"day_{d}_dense.npy")))
            sparse_parts.append(np.load(os.path.join(
                input_dir_sparse, f"day_{d}_sparse.npy")))
            label_parts.append(np.load(os.path.join(
                input_dir_labels_and_dense, f"day_{d}_labels.npy")))
        dense = np.concatenate(dense_parts)
        sparse = np.concatenate(sparse_parts)
        labels = np.concatenate(label_parts)
        perm = np.random.RandomState(seed).permutation(dense.shape[0])
        dense, sparse, labels = dense[perm], sparse[perm], labels[perm]
        os.makedirs(output_dir_shuffled, exist_ok=True)
        start = 0
        for d in range(train_days):
            n = rows_per_day[d]
            for suffix, arr in (("dense", dense), ("sparse", sparse),
                                ("labels", labels)):
                np.save(os.path.join(output_dir_shuffled,
                                     f"day_{d}_{suffix}.npy"),
                        arr[start : start + n])
            start += n
        for suffix, src_dir in (
            ("dense", input_dir_labels_and_dense),
            ("sparse", input_dir_sparse),
            ("labels", input_dir_labels_and_dense),
        ):
            src = os.path.join(src_dir, f"day_{days-1}_{suffix}.npy")
            if os.path.exists(src):
                np.save(
                    os.path.join(output_dir_shuffled,
                                 f"day_{days-1}_{suffix}.npy"),
                    np.load(src),
                )


# ---------------------------------------------------------------------------
# In-memory binary loader
# ---------------------------------------------------------------------------


class InMemoryBinaryCriteoIterDataPipe:
    """Per-rank in-memory loader over preprocessed npys, yielding Batches
    of B rows with one id per feature.

    rank / world_size: this rank's contiguous share of the rows
    (`get_file_idx_to_row_range`). hashes: each feature's modulus (its
    table's rows). shuffle_batches: the batches in a random order, drawn
    from `np.random.RandomState(seed + rank)` after the undersampling's
    draws, as JAX draws them. mmap_mode: memory-map the files instead of
    reading them (such batches go the numpy route). undersampling_rate:
    keep this fraction of the negative examples; positives are all kept.
    pin_memory: write each batch into new pinned host tensors (for a copy
    to the card); plain host tensors otherwise.
    """

    def __init__(
        self,
        dense_paths: Sequence[str],
        sparse_paths: Sequence[str],
        labels_paths: Sequence[str],
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle_batches: bool = False,
        hashes: Optional[Sequence[int]] = None,
        mmap_mode: bool = False,
        seed: int = 0,
        undersampling_rate: Optional[float] = None,
        pin_memory: bool = False,
    ):
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.shuffle_batches = shuffle_batches
        self.pin_memory = pin_memory
        self.hashes = None if hashes is None else np.asarray(hashes, np.int64)
        self._rng = np.random.RandomState(seed + rank)

        lengths = [
            BinaryCriteoUtils.get_shape_from_npy(p)[0] for p in dense_paths
        ]
        row_ranges = BinaryCriteoUtils.get_file_idx_to_row_range(
            lengths, rank, world_size
        )
        parts: Tuple[list, list, list] = ([], [], [])
        for idx, (lo, hi) in row_ranges.items():
            for out, paths in zip(parts, (dense_paths, sparse_paths,
                                          labels_paths)):
                out.append(BinaryCriteoUtils.load_npy_range(
                    paths[idx], lo, hi - lo + 1, mmap_mode))
        dense_l, sparse_l, labels_l = parts
        self.dense = np.concatenate(dense_l) if dense_l else np.zeros(
            (0, INT_FEATURE_COUNT), np.float32
        )
        self.sparse = np.concatenate(sparse_l) if sparse_l else np.zeros(
            (0, CAT_FEATURE_COUNT), np.int32
        )
        self.labels = np.concatenate(labels_l) if labels_l else np.zeros(
            (0, 1), np.int32
        )
        if self.hashes is not None:
            self.sparse = (
                self.sparse.astype(np.int64) % self.hashes[None, :]
            ).astype(np.int32)
            self.sparse = np.abs(self.sparse)
        if undersampling_rate is not None:
            keep = (self.labels[:, 0] == 1) | (
                self._rng.rand(self.labels.shape[0]) < undersampling_rate
            )
            self.dense = self.dense[keep]
            self.sparse = self.sparse[keep]
            self.labels = self.labels[keep]
        self.num_rows = self.dense.shape[0]
        self.num_batches = self.num_rows // batch_size
        # one id per feature: every batch shares these lengths, which
        # nothing writes
        self._lengths = self._empty((CAT_FEATURE_COUNT, batch_size),
                                    torch.int32).fill_(1)

    def native_route(self) -> bool:
        """Whether batches go through the C++ stager: JAX's conditions,
        in-memory C-contiguous f32 dense, int32 ids and int32 labels."""
        return (
            not isinstance(self.dense, np.memmap)
            and self.dense.dtype == np.float32
            and self.sparse.dtype == np.int32
            and self.labels.dtype == np.int32
            and self.dense.flags["C_CONTIGUOUS"]
            and self.sparse.flags["C_CONTIGUOUS"]
            and self.labels.flags["C_CONTIGUOUS"]
        )

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    def _make_batch(self, lo: int) -> Batch:
        B, F = self.batch_size, CAT_FEATURE_COUNT
        dense = self._empty((B, self.dense.shape[1]), torch.float32)
        ids = self._empty((F, B, 1), torch.int32)
        labels = self._empty((B,), torch.float32)
        if self.native_route():
            # the gather + [B, F] -> [F, B] transpose in one pass,
            # straight into the batch's (pinned) tensors
            _native_stager().stage_batch(
                self.dense.ctypes.data_as(_c_f32p),
                self.sparse.ctypes.data_as(_c_i32p),
                self.labels.ctypes.data_as(_c_i32p),
                lo, B, self.dense.shape[1], F,
                ctypes.cast(dense.data_ptr(), _c_f32p),
                ctypes.cast(ids.data_ptr(), _c_i32p),
                ctypes.cast(labels.data_ptr(), _c_f32p),
            )
        else:
            dense.numpy()[:] = self.dense[lo : lo + B]
            ids.numpy()[:] = self.sparse[lo : lo + B].T[:, :, None]
            labels.numpy()[:] = self.labels[lo : lo + B, 0]
        sb = PaddedSparseBatch(ids=ids, lengths=self._lengths,
                               keys=tuple(DEFAULT_CAT_NAMES))
        return Batch(dense_features=dense, sparse_features=sb, labels=labels)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(self.num_batches)
        if self.shuffle_batches:
            self._rng.shuffle(order)
        for b in order:
            yield self._make_batch(int(b) * self.batch_size)

    def __len__(self) -> int:
        return self.num_batches
