"""``update_max``/``tail_hist`` plain versions against the reference Pallas
kernels in interpret mode, and ``threshold_pallas`` against the
reference's. All bitwise: the plain versions repeat the kernels' f32
operations in the same order, and the tail counts are summed in the TPU
grid's order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dgc import kernel as JK
from repro.kernels.dgc import ops as jops
from repro_torch.kernels.dgc import kernel as TK
from repro_torch.kernels.dgc import ops as tops

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.7, 0.0])
def test_update_max_plain_vs_pallas(sigma):
    R = TK.BLOCK_ROWS * 2
    u, v, g = (_randn((R, TK.BLOCK_COLS), s) for s in (3, 4, 5))
    ju, jv, jm = JK.update_max(jnp.asarray(u), jnp.asarray(v), jnp.asarray(g), sigma)
    tu, tv, tm = TK.update_max(*(torch.from_numpy(a) for a in (u, v, g)), sigma)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("bins", [32, 64])
def test_tail_hist_plain_vs_pallas(bins):
    R = TK.BLOCK_ROWS * 3
    v = _randn((R, TK.BLOCK_COLS), 6)
    edges = np.linspace(1e-30, float(np.abs(v).max()), bins).astype(np.float32)
    jc = JK.tail_hist(jnp.asarray(v), jnp.asarray(edges))
    tc = TK.tail_hist(torch.from_numpy(v), torch.from_numpy(edges))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_tail_hist_counts_with_repeated_edges():
    v = _randn((TK.BLOCK_ROWS, TK.BLOCK_COLS), 7)
    edges = np.array([0.0, 0.5, 0.5, 1.0, 1.0, 1.0, 2.0, 9.0], np.float32)
    tc = TK.tail_hist(torch.from_numpy(v), torch.from_numpy(edges))
    want = [(np.abs(v) >= e).sum() for e in edges]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("n", [512, 1024, 262144, 300001])
@pytest.mark.parametrize("phi", [0.9, 0.99])
def test_threshold_pallas_vs_reference(n, phi):
    x = _randn(n, n % 97)
    th = tops.threshold_pallas(torch.from_numpy(x), phi)
    jth = jops.threshold_pallas(jnp.asarray(x), phi)
    assert th.dtype == torch.float32 and th.dim() == 0
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth))


def test_threshold_pallas_zero_vector_keeps_everything():
    x = np.zeros(5000, np.float32)
    th = tops.threshold_pallas(torch.from_numpy(x), 0.9)
    assert float(th) == 0.0 == float(jops.threshold_pallas(jnp.asarray(x), 0.9))
