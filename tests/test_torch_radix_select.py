"""The exact stable top-k's radix select (``kernels/radix_select``): its
plain version, which follows the CUDA kernels tile by tile, against the
CPU route of ``stable_topk_positions`` and the reference's
``lax.top_k(|x|, k)``, bit for bit, on the cases where a radix select or
an ordered write can go wrong; the route counter; and the CUDA route,
on fake tensors against a stubbed library (no card here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import sparsify as tsp
from repro_torch.kernels.fused_sync import ops as fops
from repro_torch.kernels.radix_select import kernel as RS
from repro_torch.obs import MetricsRegistry, use_registry

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

T = RS.TILE


def _sparse(rng, n, nnz):
    x = np.zeros(n, np.float32)
    x[rng.choice(n, nnz, replace=False)] = rng.standard_normal(nnz)
    return x


def _tied_runs(rng):
    """Distinct small magnitudes, 100 entries of 3.0 and runs of 2.0 across
    the first two tile edges: [T - 300, T + 300) and [2T - 300, 2T + 300)."""
    x = rng.uniform(0.01, 1.0, 3 * T + 100).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], x.size).astype(np.float32)
    for edge in (T, 2 * T):
        x[edge - 300:edge + 300] = rng.choice([-2.0, 2.0], 600)
    x[rng.choice(np.r_[0:T - 300, T + 300:2 * T - 300], 100, replace=False)] = 3.0
    return x


def _specials(rng):
    """±0.0, subnormals, ±inf and NaN among gaussians (three tiles less 11)."""
    x = rng.standard_normal(3 * T - 11).astype(np.float32)
    pos = rng.permutation(x.size)
    x[pos[:40]] = np.nan
    x[pos[40:50]] = -np.nan
    x[pos[50:80]] = np.inf
    x[pos[80:110]] = -np.inf
    x[pos[110:2000]] = 0.0
    x[pos[2000:4000]] = -0.0
    sub = np.array([1e-45, 1e-40, -3e-39, 5e-42, -1e-45], np.float32)
    x[pos[4000:9000]] = np.resize(sub, 5000)
    return x


def _cases():
    rng = np.random.default_rng(29)
    n = 5 * T + 123
    zeros = _sparse(rng, n, n // 10)  # 90 % zeros
    gauss = rng.standard_normal(2 * T + 777).astype(np.float32)
    equal = np.float32(1.5) * rng.choice([-1.0, 1.0], 3 * T + 5).astype(np.float32)
    tied = _tied_runs(rng)
    special = _specials(rng)
    return [
        ("90% zeros, nnz > k", zeros, n // 10 - 1000),
        ("90% zeros, nnz <= k", zeros, n // 10 + 5000),
        ("90% zeros, nnz = k", zeros, n // 10),
        ("k = 1", gauss, 1),
        ("k = n - 1", gauss, gauss.size - 1),
        ("k = n", gauss, gauss.size),
        ("all magnitudes equal", equal, 7000),
        ("ties straddling a tile edge, cut inside the second run", tied, 100 + 700),
        ("ties straddling a tile edge, cut at the edge", tied, 100 + 300),
        ("±0.0, subnormals, ±inf, NaN: the top", special, 90),
        ("±0.0, subnormals, ±inf, NaN: cut among subnormals", special, 3 * T - 11 - 6000),
        ("±0.0, subnormals, ±inf, NaN: cut among zeros", special, 3 * T - 11 - 1000),
        ("n not a multiple of the tile", gauss, 2 * T // 10),
        ("n below one tile", gauss[:1000].copy(), 100),
        ("one entry", np.array([-0.5], np.float32), 1),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,x,k", CASES, ids=[c[0] for c in CASES])
def test_plain_version_is_the_stable_topk_and_lax_top_k(name, x, k):
    xt = torch.from_numpy(x)
    got = RS.radix_topk_plain(xt, k)
    assert got.dtype == torch.int64 and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), tsp.stable_topk_positions(xt, k).numpy())
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernels' own output: every key above t in index order, then the
    # first ties of t, with their keys
    pos, keys = RS.radix_select_plain(xt, k)
    key_all = RS.abs_keys(xt)
    np.testing.assert_array_equal(keys.numpy(), key_all[pos].numpy())
    t = int(keys.min())
    above = int((key_all > t).sum())
    np.testing.assert_array_equal(pos[:above].numpy(),
                                  (key_all > t).nonzero().squeeze(1).numpy())
    np.testing.assert_array_equal(pos[above:].numpy(),
                                  (key_all == t).nonzero().squeeze(1)[:k - above].numpy())


def test_each_row_counts_once_as_plain_on_the_cpu():
    rng = np.random.default_rng(3)
    S = torch.from_numpy(rng.standard_normal((3, 5000)).astype(np.float32))
    reg = MetricsRegistry()
    with use_registry(reg):
        tsp.stable_topk_positions(S[0], 10)
        fops.select_topk_rows(S, 5000)  # k >= n: every row takes the exact sort
    c = reg.counter("sparsify.exact_topk_rows")
    assert c.value(route="plain") == 4 and c.value(route="kernel") == 0


def test_cuda_route_launches_the_kernels(monkeypatch):
    """On CUDA tensors (fake ones) ``stable_topk_positions`` goes to the
    kernels' C entry with the row's sizes and counts one ``kernel`` row; a
    failed launch raises: nothing falls back to the torch ops. (The stable
    sort of the winners has no fake CUDA kernel, so it is stubbed too.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build

    calls, rc = [], [0]

    class Stub:
        def rt_radix_select(self, *args):
            calls.append(args[1:4])
            return rc[0]

    monkeypatch.setattr(_build, "library", Stub)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(RS, "order_winners", lambda pos, keys: pos)
    launches = RS.radix_select.launches
    reg = MetricsRegistry()
    n, k = 3 * T + 5, 1000
    with use_registry(reg), FakeTensorMode():
        x = torch.empty(n, device="cuda")
        pos = tsp.stable_topk_positions(x, k)
        assert pos.shape == (k,) and pos.dtype == torch.int64
        assert tsp.stable_topk_positions(x, 0).shape == (0,)
        s = x.data_ptr() % 16 // 4
        rc[0] = 719  # cudaErrorLaunchFailure
        with pytest.raises(RuntimeError, match="radix_select failed to launch"):
            tsp.stable_topk_positions(x, k)
        with pytest.raises(ValueError, match="float32"):
            RS.radix_select(torch.empty(n, device="cuda", dtype=torch.bfloat16), k)
    assert calls == [(n, k, -(-(n + s) // T))] * 2
    assert RS.radix_select.launches == launches + 1
    assert reg.counter("sparsify.exact_topk_rows").value(route="kernel") == 3
