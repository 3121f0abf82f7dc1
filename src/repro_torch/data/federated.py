"""Federated data partitioning and mobile data residency: the port's copy
of ``repro.data.federated`` (``partition_iid``, ``partition_label_sorted``,
``partition_dirichlet``, ``ResidencyTracker``), in numpy, so both packages
draw the same shards from the same seed and remap them the same way as the
fleet moves.

The paper divides CIFAR-10 "among the MUs without any shuffling"
(sequential, so label-skewed when the source is class-ordered): IID,
label-sorted (the paper's split of a class-ordered set) and Dirichlet
non-IID (the standard benchmark for its §VI-D future work).

``ResidencyTracker``: when mobility re-associates an MU to a different
SBS, which cluster trains on its data? Three policies
(``RESIDENCY_POLICIES``) bracket the design space — ``move`` (the shard
follows the radio), ``duplicate`` (every visited cluster keeps a copy) and
``stale`` (data stays in the birth cluster; the radio moves alone). The
simulator's ``static`` residency is no tracker at all.
"""
from __future__ import annotations

import numpy as np

RESIDENCY_POLICIES = ("move", "duplicate", "stale")


def partition_iid(n: int, K: int, rng=None):
    rng = rng or np.random.default_rng(0)
    idx = rng.permutation(n)
    return np.array_split(idx, K)


def partition_label_sorted(labels, K: int):
    idx = np.argsort(labels, kind="stable")
    return np.array_split(idx, K)


def partition_dirichlet(labels, K: int, alpha: float = 0.5, rng=None):
    """Per class, a Dirichlet(α) share of its (shuffled) samples to each of
    the K MUs; small α starves some MUs of whole classes, or of all data."""
    rng = rng or np.random.default_rng(0)
    labels = np.asarray(labels)
    shards = [[] for _ in range(K)]
    for c in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == c)[0])
        props = rng.dirichlet([alpha] * K)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].append(part)
    return [np.concatenate(s) if s else np.array([], int) for s in shards]


class ResidencyTracker:
    """Which cluster(s) hold each MU's data shard as association changes.

    State is a boolean ``holds`` matrix [N, K]: ``holds[n, k]`` means
    cluster ``n`` currently trains on MU ``k``'s shard. ``update(cid)``
    applies a radio re-association under the policy:

      * ``move``      — the shard follows the MU: exactly one holder per
                        MU at all times (conservation invariant: each
                        column sums to 1).
      * ``duplicate`` — visited clusters keep a copy: holders accrue, so
                        column sums are monotonically non-decreasing and
                        at least 1 (no shard is ever lost).
      * ``stale``     — the shard never leaves the birth cluster; the
                        radio association is ignored for data placement.

    The tracker is pure bookkeeping over MU ids; the simulation engine maps
    holders to batch rows (``sim.engine``), so gradient distributions in a
    cluster really change when its resident population does.
    """

    def __init__(self, initial_cid, num_clusters: int, policy: str = "move"):
        if policy not in RESIDENCY_POLICIES:
            raise ValueError(
                f"unknown residency policy {policy!r}; "
                f"choose from {RESIDENCY_POLICIES}")
        cid = np.asarray(initial_cid, int)
        self.policy = policy
        self.N = int(num_clusters)
        self.K = len(cid)
        self.home = cid.copy()
        if cid.min() < 0 or cid.max() >= self.N:
            raise ValueError("initial_cid outside 0..N-1")
        self.holds = np.zeros((self.N, self.K), bool)
        self.holds[cid, np.arange(self.K)] = True

    def update(self, cid) -> None:
        """Apply a radio re-association (``cid`` [K]) under the policy."""
        cid = np.asarray(cid, int)
        assert cid.shape == (self.K,)
        if self.policy == "stale":
            return
        if self.policy == "move":
            self.holds[:] = False
        self.holds[cid, np.arange(self.K)] = True

    def members(self, n: int) -> np.ndarray:
        """MU ids whose data cluster ``n`` currently trains on."""
        return np.nonzero(self.holds[n])[0]

    def members_csr(self, avail=None):
        """All clusters' member lists in one pass: ``(cols, starts)`` with
        cluster ``n``'s resident MU ids (ascending, optionally pre-masked by
        the ``avail`` [K] bool vector) at ``cols[starts[n]:starts[n+1]]``.

        One row-major ``nonzero`` over the holds matrix instead of N
        per-cluster scans — the vectorized engine's per-round residency
        lookup. Each slice is bit-identical to ``members(n)`` (masked by
        ``avail``): ``nonzero`` walks rows in order, columns ascending.
        """
        h = self.holds if avail is None else self.holds & np.asarray(avail, bool)[None, :]
        rows, cols = np.nonzero(h)
        starts = np.searchsorted(rows, np.arange(self.N + 1))
        return cols, starts

    def copy_counts_at(self, idx) -> np.ndarray:
        """Holder count for the given MU ids (any-shape int array).

        Array-indexed slice of ``copy_counts()`` that only reduces the
        selected columns — O(N * len(idx)) instead of O(N * K) when the
        engine prices a handful of slots out of a million-MU fleet.
        """
        idx = np.asarray(idx, int)
        return self.holds[:, idx.ravel()].sum(axis=0).reshape(idx.shape)

    def shard_weights_at(self, idx) -> np.ndarray:
        """``shard_weights()[idx]`` without materialising the full [K]
        vector (same ``1 / n_copies`` duplicate-conservation weighting)."""
        return 1.0 / np.maximum(self.copy_counts_at(idx), 1)

    def counts(self) -> np.ndarray:
        """Resident shard count per cluster [N]."""
        return self.holds.sum(axis=1)

    def copy_counts(self) -> np.ndarray:
        """Holder count per MU [K] (>= 1; > 1 only under ``duplicate``)."""
        return self.holds.sum(axis=0)

    def shard_weights(self) -> np.ndarray:
        """Gradient weight per MU shard [K]: ``1 / n_copies``.

        Under ``duplicate`` the copies of a shard train independently in
        every holder cluster; entering each cluster's gradient at full
        weight counts that MU's data ``n_copies`` times in the cluster
        sum, skewing the effective data distribution toward mobile MUs.
        Weighting each copy's batch rows by ``1/n_copies`` conserves it
        (``move``/``stale`` always weight 1).
        """
        return 1.0 / np.maximum(self.copy_counts(), 1)

    def check_conservation(self) -> None:
        """Raise if a shard was lost (all policies), double-counted
        (``move``/``stale``, which promise exactly one holder per MU), or —
        under ``stale`` — ever left its birth cluster."""
        per_mu = self.holds.sum(axis=0)
        if (per_mu < 1).any():
            lost = np.nonzero(per_mu < 1)[0]
            raise AssertionError(f"shards lost for MUs {lost.tolist()[:8]}")
        if self.policy != "duplicate" and (per_mu > 1).any():
            dup = np.nonzero(per_mu > 1)[0]
            raise AssertionError(
                f"shards double-counted for MUs {dup.tolist()[:8]} "
                f"under policy {self.policy!r}")
        if self.policy == "stale" and \
                not self.holds[self.home, np.arange(self.K)].all():
            raise AssertionError("stale shards left their birth cluster")
