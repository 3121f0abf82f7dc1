"""Batch iterators for federated training: the port's copy of
``repro.data.pipeline``, in numpy (the draws are the reference's for the
same seed).

``FederatedBatcher`` replays each MU's fixed shard (the paper: "through the
iterations MUs train the same subset of the dataset"), yielding per-MU
minibatches with leading axis K. ``cluster_batches`` reshapes them to the
[N_clusters, local_batch, ...] layout the cluster train step consumes.
"""
from __future__ import annotations

import numpy as np


class FederatedBatcher:
    def __init__(self, arrays, shards, batch_size: int, seed: int = 0):
        """arrays: tuple of np arrays sharing axis 0; shards: list of K index
        sets. An empty shard (``partition_dirichlet`` with small α can
        starve an MU) draws from the GLOBAL pool each batch, which keeps
        the cluster layout without inventing a new partition."""
        self.arrays = arrays
        self.shards = [np.asarray(s, dtype=np.intp).reshape(-1) for s in shards]
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self._n = len(arrays[0])

    def __iter__(self):
        return self

    def _draw(self, s: np.ndarray) -> np.ndarray:
        if len(s) == 0:
            return self.rng.choice(self._n, self.bs, replace=self._n < self.bs)
        return self.rng.choice(s, self.bs, replace=len(s) < self.bs)

    def __next__(self):
        # one index draw per shard, shared by every array: paired arrays
        # (images + labels) see the SAME rows
        idx = [self._draw(s) for s in self.shards]
        outs = [np.stack([arr[i] for i in idx]) for arr in self.arrays]  # [K, bs, ...]
        return tuple(outs) if len(outs) > 1 else outs[0]


def cluster_batches(mu_batch: np.ndarray, num_clusters: int):
    """[K, bs, ...] -> [N, (K/N)*bs, ...]: concat the cluster's MU batches."""
    K = mu_batch.shape[0]
    M = K // num_clusters
    return mu_batch.reshape(num_clusters, M * mu_batch.shape[1], *mu_batch.shape[2:])
