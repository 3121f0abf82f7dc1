"""The port's copy of ``repro.wireless.topology`` (numpy only,
bit-identical).

HCN topology (paper §V-A): 750 m disk, 7 hexagonal clusters with inscribed
circle diameter 500 m, SBSs at hexagon centres, frequency-reuse coloring."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def uniform_disk(rng, n: int, radius: float, center=(0.0, 0.0)) -> np.ndarray:
    """``n`` points uniform on a disk: sqrt-radial draw, then angle.

    The one uniform-drop primitive shared by user placement, random-waypoint
    mobility, and the simulator's vectorized latency sampling — change the
    drop distribution here, everywhere follows.
    """
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack(
        [center[0] + r * np.cos(th), center[1] + r * np.sin(th)], axis=1
    )


def hex_centers(radius_in: float = 250.0):
    """Centres of the 7-hexagon flower (central + 6 ring), inscribed r given."""
    # distance between adjacent hex centres = 2 * inradius
    d = 2.0 * radius_in
    centers = [(0.0, 0.0)]
    for i in range(6):
        ang = np.pi / 6 + i * np.pi / 3
        centers.append((d * np.cos(ang), d * np.sin(ang)))
    return np.array(centers)


@dataclass
class HCNTopology:
    num_clusters: int = 7
    area_radius: float = 750.0
    hex_inradius: float = 250.0
    seed: int = 0
    mbs_pos: tuple = (0.0, 0.0)

    def __post_init__(self):
        self.sbs_pos = hex_centers(self.hex_inradius)[: self.num_clusters]
        self.rng = np.random.default_rng(self.seed)

    def drop_users(self, mus_per_cluster: int):
        """Uniform users per cluster (Assumption 1): uniform in each hexagon's
        inscribed circle; returns (positions [K,2], cluster_id [K])."""
        pos, cid = [], []
        for n, c in enumerate(self.sbs_pos):
            pos.append(uniform_disk(self.rng, mus_per_cluster,
                                    self.hex_inradius, center=c))
            cid.extend([n] * mus_per_cluster)
        return np.concatenate(pos), np.array(cid)

    def dist_to_mbs(self, pos):
        return np.maximum(np.linalg.norm(pos - np.asarray(self.mbs_pos), axis=1), 1.0)

    def dist_to_sbs(self, pos, cid):
        return np.maximum(
            np.linalg.norm(pos - self.sbs_pos[cid], axis=1), 1.0
        )

    def coloring(self, reuse: int = 1):
        """Sub-carrier color per cluster. reuse=1: all clusters share color 0
        (full spatial reuse, interference ignored beyond D_th per the paper's
        zero-interference assumption); reuse=7: each its own color."""
        if reuse == 1:
            return np.zeros(self.num_clusters, dtype=int), 1
        cols = np.arange(self.num_clusters) % reuse
        return cols, reuse
