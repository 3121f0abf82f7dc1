"""Ω payloads: ``pack_phi`` for every impl, the thresholds, masks and
compaction of the port against ``repro.core.sparsify``, bitwise (the
selections are exact and the thresholds repeat the reference's f32
arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro.kernels.dgc import ops as jdops
from repro_torch.core import sparsify as tsp

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)


def _vectors():
    rng = np.random.default_rng(0)
    heavy = rng.standard_cauchy(30000).astype(np.float32)
    ties = rng.integers(-4, 5, 20000).astype(np.float32)  # ties and signed zeros
    sparse = np.zeros(10000, np.float32)
    sparse[rng.choice(10000, 300, replace=False)] = rng.standard_normal(300)
    return {"gauss": rng.standard_normal(50000).astype(np.float32),
            "cauchy": heavy, "ties": ties, "sparse": sparse,
            "zero": np.zeros(4096, np.float32)}


VECS = _vectors()


PHIS = [(name, 0.9) for name in sorted(VECS)] + [("gauss", 0.99), ("ties", 0.99)]


@pytest.mark.parametrize("impl", ["topk", "hist", "pallas", "fused"])
@pytest.mark.parametrize("name,phi", PHIS, ids=[f"{n}-{p}" for n, p in PHIS])
def test_pack_phi_matches_reference(impl, name, phi):
    x = VECS[name]
    v, i = tsp.pack_phi(torch.from_numpy(x), phi, impl=impl)
    jv, ji = jsp.pack_phi(jnp.asarray(x), phi, impl=impl)
    assert i.dtype == torch.int32 and v.shape == (tsp.keep_count(x.size, phi),)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", sorted(VECS))
def test_threshold_for_phi_and_mask_match_reference(name):
    x = VECS[name]
    th = tsp.threshold_for_phi(torch.from_numpy(x), 0.9)
    jth = jsp.threshold_for_phi(jnp.asarray(x), 0.9)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth))
    k = tsp.keep_count(x.size, 0.9)
    pth = jdops.threshold_pallas(jnp.asarray(x), 0.9)
    m = tsp.mask_at_least_k(torch.from_numpy(x), torch.from_numpy(np.array(pth)), k)
    jm = jsp.mask_at_least_k(jnp.asarray(x), pth, k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_compact_mask_truncates_and_pads_like_reference():
    x = np.arange(1, 101, dtype=np.float32)
    for keep in (5, 40):  # fewer and more candidates than k
        mask = np.zeros(100, bool)
        mask[::100 // keep] = True
        v, i = tsp.compact_mask(torch.from_numpy(x), torch.from_numpy(mask), 20)
        jv, ji = jsp.compact_mask(jnp.asarray(x), jnp.asarray(mask), 20)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("k", [1, 7, 1000, 4999, 5000])
def test_stable_topk_is_stable_argsort(k):
    x = np.random.default_rng(k).integers(-9, 10, 5000).astype(np.float32)
    x[::7] = -0.0
    pos = tsp.stable_topk_positions(torch.from_numpy(x), k)
    want = np.argsort(-np.abs(x), kind="stable")[:k]
    np.testing.assert_array_equal(pos.numpy(), want)


def test_unpack_topk_and_keep_count():
    assert tsp.keep_count(1000, 0.9) == jsp.keep_count(1000, 0.9) == 100
    assert tsp.keep_count(3, 0.999) == 1
    out = tsp.unpack_topk(torch.tensor([1.5, -2.0]), torch.tensor([3, 0], dtype=torch.int32), 5)
    np.testing.assert_array_equal(out.numpy(), [-2.0, 0, 0, 1.5, 0])
