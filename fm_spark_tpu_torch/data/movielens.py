"""MovieLens ratings → fixed-nnz FM inputs (config 1, the quality anchor;
a copy of ``fm_spark_tpu/data/movielens.py``: the same file gives the
same arrays in both packages).

MovieLens-100K ``u.data`` is ``user \\t item \\t rating \\t timestamp``.
The classic FM encoding (Rendle 2010, the reference's lineage) is one-hot
user + one-hot item: ``nnz = 2``, feature space = num_users + num_items —
small enough that ids are direct indices, no hashing. Labels: raw rating
for regression, or rating ≥ threshold for the logistic config
(BASELINE.json:7 names logistic loss).
"""

from __future__ import annotations

import numpy as np


def load_ratings(path: str, task: str = "classification",
                 positive_threshold: float = 4.0, sep: str = "\t"):
    """Parse a ratings file → ``((ids, vals, labels), meta)``.

    ids[N,2] = [user_index, num_users + item_index] — dense re-indexed so
    the feature space is exactly num_users + num_items.
    """
    raw = np.loadtxt(path, delimiter=sep, usecols=(0, 1, 2),
                     dtype=np.float64, ndmin=2)
    users = raw[:, 0].astype(np.int64)
    items = raw[:, 1].astype(np.int64)
    ratings = raw[:, 2].astype(np.float32)
    uniq_users, u_idx = np.unique(users, return_inverse=True)
    uniq_items, i_idx = np.unique(items, return_inverse=True)
    num_users, num_items = uniq_users.shape[0], uniq_items.shape[0]
    ids = np.stack([u_idx, num_users + i_idx], axis=1).astype(np.int32)
    vals = np.ones(ids.shape, np.float32)
    if task == "classification":
        labels = (ratings >= positive_threshold).astype(np.float32)
    elif task == "regression":
        labels = ratings
    else:
        raise ValueError(f"unknown task {task!r}")
    meta = {
        "num_users": num_users,
        "num_items": num_items,
        "num_features": num_users + num_items,
        "user_ids": uniq_users,
        "item_ids": uniq_items,
    }
    return (ids, vals, labels), meta


def synthesize_ratings(path: str, num_users: int = 200, num_items: int = 300,
                       num_ratings: int = 5000, seed: int = 0,
                       latent_rank: int = 4):
    """Write a u.data-shaped synthetic ratings file with real low-rank
    structure (so an FM can actually learn it in tests)."""
    rng = np.random.default_rng(seed)
    pu = rng.normal(0, 1, (num_users, latent_rank))
    qi = rng.normal(0, 1, (num_items, latent_rank))
    bu = rng.normal(0, 0.3, num_users)
    bi = rng.normal(0, 0.3, num_items)
    u = rng.integers(0, num_users, num_ratings)
    i = rng.integers(0, num_items, num_ratings)
    score = 3.2 + bu[u] + bi[i] + (pu[u] * qi[i]).sum(1) / np.sqrt(latent_rank)
    rating = np.clip(np.rint(score + rng.normal(0, 0.4, num_ratings)), 1, 5)
    ts = rng.integers(8.7e8, 8.9e8, num_ratings)
    with open(path, "w") as f:
        for r in range(num_ratings):
            f.write(f"{u[r] + 1}\t{i[r] + 1}\t{int(rating[r])}\t{ts[r]}\n")
