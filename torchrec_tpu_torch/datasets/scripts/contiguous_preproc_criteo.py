#!/usr/bin/env python3
"""Criteo sparse-id re-indexing CLI (ids -> contiguous, with frequency
thresholding).

ref: torchrec/datasets/scripts/contiguous_preproc_criteo.py — maps raw
hashed categorical ids to contiguous ids per feature so embedding tables
can be sized to the true cardinality. Logic in
BinaryCriteoUtils.sparse_to_contiguous. The CLI is
torchrec_tpu/datasets/scripts/contiguous_preproc_criteo.py's:

  python -m torchrec_tpu_torch.datasets.scripts.contiguous_preproc_criteo \
      --input_dir NPY --output_dir CONTIG --frequency_threshold 3
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from torchrec_tpu_torch.datasets.criteo import BinaryCriteoUtils


def parse_args(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Criteo sparse -> contiguous preprocessing script."
    )
    parser.add_argument(
        "--input_dir", type=str, required=True,
        help="Directory of day_{0-23}_sparse.npy files.",
    )
    parser.add_argument(
        "--output_dir", type=str, required=True,
        help="Directory for the re-indexed npy files.",
    )
    parser.add_argument(
        "--frequency_threshold", type=int, default=0,
        help="Ids seen fewer times than this map to id 0.",
    )
    return parser.parse_args(argv)


def main(argv: List[str]) -> None:
    args = parse_args(argv)
    input_files = sorted(
        os.path.join(args.input_dir, f)
        for f in os.listdir(args.input_dir)
        if f.endswith("_sparse.npy")
    )
    if not input_files:
        raise ValueError(
            f"no '*_sparse.npy' files in directory: {args.input_dir}"
        )
    print(f"Processing {input_files} -> {args.output_dir}")
    BinaryCriteoUtils.sparse_to_contiguous(
        input_files, args.output_dir,
        frequency_threshold=args.frequency_threshold,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
