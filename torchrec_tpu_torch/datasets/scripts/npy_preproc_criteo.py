#!/usr/bin/env python3
"""Criteo tsv -> npy preprocessing CLI.

ref: torchrec/datasets/scripts/npy_preproc_criteo.py — converts raw
`day_{0..23}` TSV files into the (dense, sparse, labels) npy triples
consumed by InMemoryBinaryCriteoIterDataPipe. The conversion itself
(including the C++ fast parser) lives in
torchrec_tpu_torch.datasets.criteo.BinaryCriteoUtils.tsv_to_npys; the
CLI is torchrec_tpu/datasets/scripts/npy_preproc_criteo.py's:

  python -m torchrec_tpu_torch.datasets.scripts.npy_preproc_criteo \
      --input_dir RAW --output_dir NPY
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from torchrec_tpu_torch.datasets.criteo import BinaryCriteoUtils


def parse_args(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Criteo tsv -> npy preprocessing script."
    )
    parser.add_argument(
        "--input_dir", type=str, required=True,
        help="Directory of Criteo tsv files named day_{0-23}.",
    )
    parser.add_argument(
        "--output_dir", type=str, required=True,
        help="Directory for the output npy files.",
    )
    return parser.parse_args(argv)


def main(argv: List[str]) -> None:
    args = parse_args(argv)
    for f in sorted(os.listdir(args.input_dir)):
        in_path = os.path.join(args.input_dir, f)
        if not os.path.isfile(in_path):
            continue
        dense = os.path.join(args.output_dir, f + "_dense.npy")
        sparse = os.path.join(args.output_dir, f + "_sparse.npy")
        labels = os.path.join(args.output_dir, f + "_labels.npy")
        print(f"Processing {in_path} -> {dense}, {sparse}, {labels}")
        BinaryCriteoUtils.tsv_to_npys(in_path, dense, sparse, labels)


if __name__ == "__main__":
    main(sys.argv[1:])
