"""Ω payloads: ``pack_phi`` for every impl, the thresholds, masks and
compaction of the port against ``repro.core.sparsify``, bitwise (the
selections are exact and the thresholds repeat the reference's f32
arithmetic). ``omega`` and ``dgc_step`` are held against the reference
jitted, as its engine runs them: XLA then makes ``v * mask`` a select
(+0.0 where masked out) and ``σ·u + g`` one fused multiply-add, and the
port computes that, compared as bit patterns."""
from functools import partial

import jax
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


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def test_mask_at_least_k_bf16_compares_in_f32():
    """A bf16 x against f32 thresholds that bf16 cannot represent: jnp
    promotes the compare to f32; a bf16 compare rounds the threshold first
    and keeps other entries."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    differs = 0
    for th in np.linspace(0.01, 2.5, 400, dtype=np.float32):
        want = np.asarray(jsp.mask_at_least_k(jx, jnp.float32(th), 10))
        got = tsp.mask_at_least_k(tx, torch.tensor(th), 10)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"th={th}")
        differs += int(((tx.abs() >= torch.tensor(th)).numpy() != want).sum())
    assert differs > 0  # a bf16 compare would have failed above


@pytest.mark.parametrize("k", [1, 5, 300, 2999])
def test_topk_mask_ties_match_reference(k):
    x = np.random.default_rng(k).integers(-4, 5, (30, 100)).astype(np.float32)
    x[::3, ::7] = -0.0
    got = tsp.topk_mask(torch.from_numpy(x), k)
    assert got.shape == x.shape and int(got.sum()) == k
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsp.topk_mask(jnp.asarray(x), k)))


IMPLS = ["topk", "hist", "pallas", "fused"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name,phi", [("gauss", 0.9), ("ties", 0.99), ("sparse", 0.9),
                                      ("zero", 0.9), ("gauss", 0.0)])
def test_omega_matches_reference(impl, name, phi):
    x = VECS[name]
    js, jm = jax.jit(partial(jsp.omega, phi=phi, impl=impl))(jnp.asarray(x))
    ts, tm = tsp.omega(torch.from_numpy(x), phi, impl=impl)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("phi", [0.9, 0.99])
def test_dgc_step_matches_reference(impl, phi):
    rng = np.random.default_rng(11)
    u, v, g = (rng.standard_normal(20000).astype(np.float32) for _ in range(3))
    want = jax.jit(partial(jsp.dgc_step, sigma=0.9, phi=phi, impl=impl))(u, v, g)
    got = tsp.dgc_step(*(torch.from_numpy(a) for a in (u, v, g)), 0.9, phi, impl=impl)
    for name, a, b in zip(("ghat", "u", "v"), want, got):
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)
    k = tsp.keep_count(u.size, phi)
    assert int((got[1] == 0).sum()) >= k and int((got[2] == 0).sum()) >= k
