"""``block_select`` and the fused selection: the port's plain kernel version
against the reference Pallas kernel in interpret mode, and
``select_topk_rows`` against the reference and ``lax.top_k`` on both the
CPU branch and the block-compaction branch. All comparisons are bitwise:
the selection is exact, so no tolerance applies."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro.kernels.fused_sync import kernel as JK
from repro.kernels.fused_sync import ops as jops
from repro_torch.core import sparsify as tsp
from repro_torch.kernels.fused_sync import kernel as TK
from repro_torch.kernels.fused_sync import ops as tops
from repro_torch.obs import MetricsRegistry, use_registry

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

BE = TK.BLOCK_ELEMS


def _pallas_block_select(x_np, th, cap_blk, n):
    xp = np.pad(x_np, (0, (-x_np.size) % BE))
    v, i, c = JK.block_select(jnp.asarray(xp).reshape(-1, JK.BLOCK_COLS), th,
                              cap_blk, n, interpret=True)
    return np.asarray(v), np.asarray(i), np.asarray(c)


def _th(v):
    return torch.tensor([v], dtype=torch.float32)


@pytest.mark.parametrize("n", [BE, 3 * BE - 777])
@pytest.mark.parametrize("padded_input", [True, False])
def test_block_select_plain_vs_pallas(n, padded_input):
    x = np.random.default_rng(n % 17).standard_normal(n).astype(np.float32)
    v, i, c = _pallas_block_select(x, 1.5, 4096, n)
    # the port reads past-the-end positions as zeros: the unpadded vector
    # gives the reference's padded-tile answer (pad index n, not x.size)
    xin = np.pad(x, (0, (-n) % BE)) if padded_input else x
    tv, ti, tc = TK.block_select(torch.from_numpy(xin), _th(1.5), 4096, n)
    np.testing.assert_array_equal(tv.numpy(), v)
    np.testing.assert_array_equal(ti.numpy(), i)
    np.testing.assert_array_equal(tc.numpy(), c)


def test_block_select_truncates_at_capacity():
    x = np.ones(BE, np.float32)
    v, i, c = _pallas_block_select(x, 0.5, 128, BE)
    tv, ti, tc = TK.block_select(torch.from_numpy(x), _th(0.5), 128, BE)
    assert int(tc[0, 0]) == BE
    np.testing.assert_array_equal(ti.numpy(), i)
    np.testing.assert_array_equal(ti[0].numpy(), np.arange(128, dtype=np.int32))
    np.testing.assert_array_equal(tv.numpy(), v)


@pytest.mark.parametrize("cap", [1023, 1024, 1025, 2047, 2048, 2049])
def test_block_select_capacity_at_chunk_boundaries(cap):
    """Every entry a candidate, so the capacity is reached exactly at, one
    before or one after the first two 1,024-element chunk boundaries."""
    x = np.ones(2 * BE, np.float32)
    x[1::3] = -2.0
    v, i, c = _pallas_block_select(x, 0.5, cap, x.size)
    tv, ti, tc = TK.block_select(torch.from_numpy(x), _th(0.5), cap, x.size)
    for a, b in ((tv, v), (ti, i), (tc, c)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(ti[0].numpy(), np.arange(cap, dtype=np.int32))


@pytest.mark.parametrize("th", [1.5, 0.0])
def test_block_select_nan_and_inf_entries(th):
    """|NaN| >= th is false for any th, ±inf is a candidate."""
    n = 2 * BE + 777
    x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    x[::1001], x[5::997], x[7::991] = np.nan, np.inf, -np.inf
    v, i, c = _pallas_block_select(x, th, 6000, n)
    tv, ti, tc = TK.block_select(torch.from_numpy(x), _th(th), 6000, n)
    for a, b in ((tv, v), (ti, i), (tc, c)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert not np.isnan(tv.numpy()).any() and np.isinf(tv.numpy()).any()


def test_block_select_all_zero_and_tiny_threshold():
    x = np.zeros(2 * BE - 5, np.float32)
    tiny = float(np.finfo(np.float32).tiny)
    v, i, c = _pallas_block_select(x, tiny, 64, x.size)
    tv, ti, tc = TK.block_select(torch.from_numpy(x), _th(tiny), 64, x.size)
    for a, b in ((tv, v), (ti, i), (tc, c)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(tc.sum()) == 0 and (ti.numpy() == x.size).all()


def test_plain_candidates_finish_to_exact_topk():
    n = 2 * BE
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    k = n // 10
    xt = torch.from_numpy(x)
    th = tops._row_threshold(xt[None, :], k, bins=128, sample=16384, margin=2)
    jth = jops._row_threshold(jnp.abs(jnp.asarray(x))[None, :], k, bins=128,
                              sample=16384, margin=2)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth))
    v, i, c = TK.block_select(xt, th, BE // 4, n)
    vals, idx = tops._finish_topk(v.reshape(1, -1), i.reshape(1, -1), k)
    _, exact = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(exact))


def _check_rows(S, k, interpret):
    vals, idx = tops.select_topk_rows(torch.from_numpy(S), k, interpret=interpret)
    jv, ji = jops.select_topk_rows(jnp.asarray(S), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    for r in range(S.shape[0]):
        tv, ti = jax.lax.top_k(jnp.abs(jnp.asarray(S[r])), min(k, S.shape[1]))
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(ti))
        np.testing.assert_array_equal(vals[r].abs().numpy(), np.asarray(tv))


@pytest.mark.parametrize("interpret", [True, False], ids=["cpu-branch", "block-branch"])
@pytest.mark.parametrize("n,frac", [(4096, 0.1), (65536, 0.01), (100001, 0.1),
                                    (8192, 0.5)])
def test_select_topk_rows_bit_identical(n, frac, interpret):
    S = np.random.default_rng(n % 31).standard_normal((3, n)).astype(np.float32)
    _check_rows(S, max(1, int(frac * n)), interpret)


@pytest.mark.parametrize("interpret", [True, False], ids=["cpu-branch", "block-branch"])
def test_select_topk_rows_edge_cases(interpret):
    _check_rows(np.zeros((2, 1000), np.float32), 100, interpret)  # zero rows
    E = np.zeros((1, 1000), np.float32)
    E[0, 7] = 3.0
    _check_rows(E, 100, interpret)  # near-empty
    _check_rows(np.full((1, 2048), 2.5, np.float32), 200, interpret)  # all tied
    ties = np.random.default_rng(1).integers(-3, 4, (2, 5000)).astype(np.float32)
    _check_rows(ties, 1200, interpret)  # heavy ties, signed zeros
    F = np.random.default_rng(9).standard_normal((1, 512)).astype(np.float32)
    _check_rows(F, 512, interpret)  # k = n


def _outcomes(reg):
    """(calls the candidates answered, calls the exact fallback answered)."""
    c = reg.counter("fused.select_calls")
    return c.value(outcome="candidates"), c.value(outcome="fallback")


def test_block_branch_takes_the_kernel_path_without_fallback():
    S = np.random.default_rng(4).standard_normal((2, 3 * BE + 11)).astype(np.float32)
    with use_registry(MetricsRegistry()) as reg:
        _check_rows(S, S.shape[1] // 10, False)
    assert _outcomes(reg) == (1, 0)


def test_block_branch_counts_the_exact_fallback():
    """Fewer than k nonzeros (a drift where most parameters did not move):
    the candidates cannot answer, the exact fallback does, and is counted."""
    S = np.zeros((2, 3 * BE), np.float32)
    S[:, ::97] = np.random.default_rng(6).standard_normal((2, S[0, ::97].size))
    with use_registry(MetricsRegistry()) as reg:
        _check_rows(S, S.shape[1] // 10, False)
    assert _outcomes(reg) == (0, 1)


def test_select_topk_rows_records_each_outcome_in_order():
    """One count per compacting call: of the candidates where they
    answered, of the exact fallback where it did."""
    dense = np.random.default_rng(4).standard_normal((1, 3 * BE)).astype(np.float32)
    sparse = np.zeros((1, 3 * BE), np.float32)
    sparse[0, ::97] = 1.0  # fewer than k nonzeros
    k = 3 * BE // 10
    with use_registry(MetricsRegistry()) as reg:
        for S, want in ((dense, (1, 0)), (sparse, (1, 1)), (dense, (2, 1))):
            tops.select_topk_rows(torch.from_numpy(S), k, interpret=False)
            assert _outcomes(reg) == want
    for name in ("finished", "fallbacks", "outcomes"):
        assert not hasattr(tops.select_topk_rows, name)


@pytest.mark.parametrize("phi", [0.9, 0.99])
def test_fused_pack_phi_equals_reference(phi):
    x = np.random.default_rng(5).standard_normal(40000).astype(np.float32)
    v, i = tsp.pack_phi(torch.from_numpy(x), phi, impl="fused")
    jv, ji = jsp.pack_phi(jnp.asarray(x), phi, impl="fused")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert i.dtype == torch.int32
