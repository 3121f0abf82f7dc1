"""Federated data partitioning: a copy of ``repro.data.federated``'s
``partition_iid``, in numpy so both packages draw the same shards from the
same seed."""
from __future__ import annotations

import numpy as np


def partition_iid(n: int, K: int, rng=None):
    rng = rng or np.random.default_rng(0)
    idx = rng.permutation(n)
    return np.array_split(idx, K)
