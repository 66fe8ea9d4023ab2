"""MovieLens 20M / 25M dataset pipes over the csv module.

Counterpart of torchrec_tpu/datasets/movielens.py: the same rows, as
dicts of Python numbers and strings.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator


RATINGS_FILENAME = "ratings.csv"
MOVIES_FILENAME = "movies.csv"

DEFAULT_RATINGS_COLUMN_NAMES = ["userId", "movieId", "rating", "timestamp"]
DEFAULT_MOVIES_COLUMN_NAMES = ["movieId", "title", "genres"]


def _ratings(root: str) -> Iterator[Dict]:
    with open(os.path.join(root, RATINGS_FILENAME), newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            yield {
                "userId": int(row["userId"]),
                "movieId": int(row["movieId"]),
                "rating": float(row["rating"]),
                "timestamp": int(row["timestamp"]),
            }


def _with_movies(root: str, include_movies_data: bool) -> Iterator[Dict]:
    if not include_movies_data:
        yield from _ratings(root)
        return
    movies: Dict[int, Dict] = {}
    with open(os.path.join(root, MOVIES_FILENAME), newline="") as f:
        for row in csv.DictReader(f):
            movies[int(row["movieId"])] = {
                "title": row["title"],
                "genres": row["genres"],
            }
    for r in _ratings(root):
        r.update(movies.get(r["movieId"], {"title": "", "genres": ""}))
        yield r


def movielens_20m(
    root: str, include_movies_data: bool = False
) -> Iterator[Dict]:
    """ref: movielens.py:81."""
    return _with_movies(root, include_movies_data)


def movielens_25m(
    root: str, include_movies_data: bool = False
) -> Iterator[Dict]:
    """ref: movielens.py:112."""
    return _with_movies(root, include_movies_data)
