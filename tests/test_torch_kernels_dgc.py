"""``update_max``/``tail_hist``/``apply_mask`` plain versions against the
reference Pallas kernels in interpret mode, and ``threshold_pallas``,
``omega_pallas`` and ``dgc_step_pallas`` against the reference's. All
bitwise: the plain versions repeat the kernels' f32 operations in the same
order, and the tail counts are summed in the TPU grid's order.
``apply_mask`` outputs are compared as bit patterns (``torch.equal`` and
``==`` treat -0.0 and +0.0 as equal): the reference body, as XLA compiles
it, gives +0.0 in ĝ where v is masked out and -0.0 in u'', v'' where a
negative entry is masked in."""
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


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def _mask_inputs(seed):
    R = TK.BLOCK_ROWS
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((R, TK.BLOCK_COLS)).astype(np.float32)
    v = rng.standard_normal((R, TK.BLOCK_COLS)).astype(np.float32)
    v[0, :6] = [np.nan, -0.0, 0.0, -3.0, -1e-3, np.nan]  # signs of zeros, NaNs
    u[0, :6] = [1.0, -1.0, -0.0, -0.0, 2.0, np.nan]
    return u, v


@pytest.mark.parametrize("case", ["quantile", "zero", "above-all", "negatives"])
def test_apply_mask_plain_vs_pallas_bit_patterns(case):
    u, v = _mask_inputs(8)
    fin = np.abs(v[np.isfinite(v)])
    th = {"quantile": float(np.quantile(fin, 0.9)), "zero": 0.0,
          "above-all": float(fin.max()) * 2, "negatives": 1e-4}[case]
    if case == "negatives":  # every entry masked out is negative
        v = -np.abs(v)
    th = np.float32(th)
    want = JK.apply_mask(jnp.asarray(u), jnp.asarray(v), th)
    got = TK.apply_mask(torch.from_numpy(u), torch.from_numpy(v),
                        torch.tensor(th))
    for name, a, b in zip(("ghat", "u", "v"), want, got):
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)
    if case == "negatives":  # -0.0 where a negative v is masked in
        assert (np.signbit(got[2].numpy()) & (got[2].numpy() == 0)).any()


@pytest.mark.parametrize("n", [512, 262144, 300001])
@pytest.mark.parametrize("phi", [0.9, 0.99])
def test_omega_and_dgc_step_pallas_vs_reference(n, phi):
    rng = np.random.default_rng(n)
    u, v, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    js, jm = jops.omega_pallas(jnp.asarray(v), phi)
    ts, tm = tops.omega_pallas(torch.from_numpy(v), phi)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jops.dgc_step_pallas(*(jnp.asarray(a) for a in (u, v, g)), 0.9, phi)
    got = tops.dgc_step_pallas(*(torch.from_numpy(a) for a in (u, v, g)), 0.9, phi)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_omega_and_dgc_step_pallas_all_zero():
    x = np.zeros(5000, np.float32)
    js, jm = jops.omega_pallas(jnp.asarray(x), 0.9)
    ts, tm = tops.omega_pallas(torch.from_numpy(x), 0.9)
    assert tm.all() and np.asarray(jm).all()  # th = 0 keeps everything
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    got = tops.dgc_step_pallas(*(torch.from_numpy(x) for _ in range(3)), 0.9, 0.9)
    want = jops.dgc_step_pallas(*(jnp.asarray(x) for _ in range(3)), 0.9, 0.9)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("shape", [(2048,), (64, 1024), (8, 16, 512)])
def test_dgc_step_pallas_shapes(shape):
    rng = np.random.default_rng(1)
    u = rng.standard_normal(shape).astype(np.float32)
    v = np.zeros(shape, np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = jops.dgc_step_pallas(*(jnp.asarray(a) for a in (u, v, g)), 0.5, 0.9)
    got = tops.dgc_step_pallas(*(torch.from_numpy(a) for a in (u, v, g)), 0.5, 0.9)
    for a, b in zip(want, got):
        assert tuple(b.shape) == shape
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_omega_pallas_bf16_matches_reference():
    """The mask compares |x| with the f32 threshold in f32, as jnp
    promotes the bf16 x; a bf16 compare rounds the threshold instead."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    js, jm = jops.omega_pallas(jx, 0.95)
    ts, tm = tops.omega_pallas(tx, 0.95)
    assert ts.dtype == torch.bfloat16 and ts.shape == (4096,)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    bf16_compare = tx.abs() >= tops.threshold_pallas(tx, 0.95)
    assert (bf16_compare.numpy() != np.asarray(jm)).sum() > 0  # the trap is live
    np.testing.assert_array_equal(_bits(ts.float()), _bits(js.astype(jnp.float32)))
