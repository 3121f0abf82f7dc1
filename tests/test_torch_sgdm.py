"""SGDM's update (``optim.SGDM`` over ``kernels/sgdm``): a plain numpy
version that follows the CUDA kernel's order of roundings, against
``SGDM.update``'s torch route, bit for bit (bf16 and f32 params, weight
decay on and off, Nesterov, leaves of every length class, a row view of an
[N, ...] state, a tree of mixed dtypes); the route counter; and the CUDA
route on fake tensors against a stubbed library (no card here)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sgdm import kernel as SK
from repro_torch.obs import MetricsRegistry, use_registry
from repro_torch.optim import SGDM, warmup_step_decay

torch.set_num_threads(2)

F = np.float32
N_ROWS, ROW = 3, 1  # the [N, ...] state and the row the update takes
# a row's leaf shapes: 1-D leaves (decay takes ``+ 0.0`` there), an [L, 1]
# norm placeholder (2-D: decayed), lengths around the kernel's 8-entry unit,
# a leaf of size 0
SHAPES = [(5,), (4, 1), (13, 7), (0,), (1,), (8,), (9,), (3, 5, 11), (3, 0)]


def bf16_bits_to_f32(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x):
    """Round to nearest even, as ``__float2bfloat16_rn``; NaN stays NaN."""
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), ((u >> 16) | 0x40).astype(np.uint16), r)


def kernel_order(g, m, p, lr, mu, wd, nesterov, ndim):
    """The kernel's arithmetic on f32 arrays, one rounding an op: returns
    (m, p) in f32 (p before its cast to the param's dtype)."""
    if wd:
        g = g + (F(wd) * p if ndim >= 2 else F(0.0))
    m = m * F(mu)
    m = m + g
    step = g + F(mu) * m if nesterov else m
    return m, p - F(lr) * step


def _values(rng, shape, scale):
    """Gaussian values with a few -0.0, +0.0 and f32 subnormals of both signs."""
    x = (rng.standard_normal(shape) * scale).astype(F)
    flat = x.reshape(-1)
    if flat.size >= 4:
        pick = rng.choice(flat.size, min(flat.size, 8), replace=False)
        flat[pick] = np.array([-0.0, 0.0, -1e-45, 3e-39, -2e-40, -0.0, 1e-44, -0.0],
                              F)[:pick.size]
    return x


def _to_torch(x, dtype):
    if dtype == torch.bfloat16:
        return torch.from_numpy(f32_to_bf16_bits(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _as_f32(t):
    if t.dtype == torch.bfloat16:
        return bf16_bits_to_f32(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy().copy()


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _tree(xs):
    """A dict tree of the leaves in their order (``tree_leaves`` sorts keys)."""
    return {f"l{i:03d}": x for i, x in enumerate(xs)}


def _state(rng, shapes, dtype):
    """[N_ROWS, *shape] params (``dtype``) and f32 moments, seeded."""
    P = [_to_torch(_values(rng, (N_ROWS, *s), 0.05), dtype) for s in shapes]
    M = [torch.from_numpy(_values(rng, (N_ROWS, *s), 1e-3)) for s in shapes]
    return P, M


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_route_is_the_kernels_order_of_roundings(dtype, wd, nesterov):
    """Two steps of ``SGDM.update`` on row ``ROW`` of an [N, ...] state
    (views, as ``core.hfl`` passes them) against ``kernel_order``, bit for
    bit in params and moments; the other rows keep their bits."""
    rng = np.random.default_rng(31 + 2 * (dtype == torch.float32) + (wd > 0))
    P, M = _state(rng, SHAPES, dtype)
    before = [(_bits(p).copy(), _bits(m).copy()) for p, m in zip(P, M)]
    opt = SGDM(momentum=0.9, weight_decay=wd, nesterov=nesterov)
    sched = warmup_step_decay(0.1, 3, (1,))
    params = _tree([p[ROW] for p in P])
    state = {"m": _tree([m[ROW] for m in M])}
    for step in range(2):
        lr = sched(step)
        G = [_to_torch(_values(rng, s, 1e-2), dtype) for s in SHAPES]
        want = [kernel_order(_as_f32(G[i]), M[i][ROW].numpy().copy(),
                             _as_f32(P[i][ROW]), lr, 0.9, wd, nesterov, len(s))
                for i, s in enumerate(SHAPES)]
        opt.update(_tree(G), state, params, lr)
        for i, (wm, wp) in enumerate(want):
            np.testing.assert_array_equal(_bits(M[i][ROW]), wm.view(np.int32))
            wbits = f32_to_bf16_bits(wp).view(np.int16) if dtype == torch.bfloat16 \
                else wp.view(np.int32)
            np.testing.assert_array_equal(_bits(P[i][ROW]), wbits)
    for (pb, mb), p, m in zip(before, P, M):
        for n in range(N_ROWS):
            if n != ROW:
                np.testing.assert_array_equal(_bits(p[n]), pb[n])
                np.testing.assert_array_equal(_bits(m[n]), mb[n])


def test_mixed_dtype_tree():
    """One update of a tree that mixes bf16 and f32 leaves, as mamba2's does
    (its A_log, D, dt_bias and norm scale are f32), weight decay and Nesterov
    on, against ``kernel_order`` in each leaf's dtype."""
    rng = np.random.default_rng(7)
    bf, f32 = torch.bfloat16, torch.float32
    leaves = [((24, 40), bf), ((24,), f32), ((3, 24), f32), ((7,), bf), ((24, 1), f32),
              ((17,), f32), ((5, 9), bf)]
    P = [_to_torch(_values(rng, s, 0.05), dt) for s, dt in leaves]
    M = [torch.from_numpy(_values(rng, s, 1e-3)) for s, _ in leaves]
    G = [_to_torch(_values(rng, s, 1e-2), dt) for s, dt in leaves]
    want = [kernel_order(_as_f32(g), m.numpy().copy(), _as_f32(p), 0.05, 0.9, 1e-4, True,
                         len(s)) for g, m, p, (s, _) in zip(G, M, P, leaves)]
    SGDM(momentum=0.9, weight_decay=1e-4, nesterov=True).update(
        _tree(G), {"m": _tree(M)}, _tree(P), 0.05)
    for (wm, wp), m, p, (_, dt) in zip(want, M, P, leaves):
        np.testing.assert_array_equal(_bits(m), wm.view(np.int32))
        wbits = f32_to_bf16_bits(wp).view(np.int16) if dt == bf else wp.view(np.int32)
        np.testing.assert_array_equal(_bits(p), wbits)


def test_each_leaf_counts_once_as_plain_on_the_cpu():
    rng = np.random.default_rng(3)
    P, M = _state(rng, SHAPES, torch.bfloat16)
    G = [torch.zeros_like(p[0]) for p in P]
    reg = MetricsRegistry()
    with use_registry(reg):
        opt = SGDM(momentum=0.9, weight_decay=1e-4)
        for n in range(2):
            opt.update(_tree(G), {"m": _tree([m[n] for m in M])},
                       _tree([p[n] for p in P]), 0.1)
    c = reg.counter("optim.sgdm_leaves")
    assert c.value(route="plain") == 2 * len(SHAPES) and c.value(route="kernel") == 0


def _stub_library(monkeypatch):
    """The C entry stubbed: returns the list its launches go to, as (n,
    decay, bf16, lr, momentum, weight decay, nesterov), and the return code
    it gives; ``sgdm_plain`` stubbed (fake tensors have no CPU kernels here)
    to the list of the param shapes it got."""
    calls, plain, rc = [], [], [0]

    class Stub:
        def rt_sgdm(self, g, m, p, n, decay, bf16, lr, mu, wd, nesterov, stream):
            calls.append((n, decay, bf16, lr, mu, wd, nesterov))
            return rc[0]

    monkeypatch.setattr(_build, "library", Stub)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(SK, "sgdm_plain", lambda g, m, p, *hyper: plain.append(p.shape))
    return calls, plain, rc


def _update(opt, leaves, lr):
    return opt.update(_tree([l[0] for l in leaves]), {"m": _tree([l[1] for l in leaves])},
                      _tree([l[2] for l in leaves]), lr)


def test_cuda_route_launches_the_kernel(monkeypatch):
    """On CUDA tensors (fake ones) every leaf goes to the C entry, one launch
    a leaf with its length, decay term and dtype (a leaf of size 0 counts
    but is not sent); a ``meta`` leaf takes the torch ops; each leaf counts
    once by route; a failed launch raises: nothing falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls, plain, rc = _stub_library(monkeypatch)
    launches = SK.sgdm_update.launches
    reg = MetricsRegistry()
    bf, f32 = torch.bfloat16, torch.float32
    with use_registry(reg), FakeTensorMode():
        z = lambda *s, dtype=f32, device="cuda": torch.zeros(s, dtype=dtype, device=device)
        leaves = [  # (grad, moment, param)
            (z(3, 8, dtype=bf), z(3, 8), z(3, 8, dtype=bf)),
            (z(9, dtype=bf), z(9), z(9, dtype=bf)),
            (z(5), z(5), z(5)),                                 # f32 param
            (z(0, dtype=bf), z(0), z(0, dtype=bf)),             # size 0
            (z(2, 6, dtype=bf, device="meta"), z(2, 6, device="meta"),
             z(2, 6, dtype=bf, device="meta")),                 # meta: the torch ops
        ]
        assert [SK.takes(*leaf) for leaf in leaves] == [True] * 4 + [False]
        _update(SGDM(momentum=0.9, weight_decay=1e-4, nesterov=True), leaves, 0.25)
        assert calls == [(24, SK.DECAY, 1, 0.25, 0.9, 1e-4, 1),
                         (9, SK.ADD_ZERO, 1, 0.25, 0.9, 1e-4, 1),
                         (5, SK.ADD_ZERO, 0, 0.25, 0.9, 1e-4, 1)]
        assert plain == [(2, 6)]
        _update(SGDM(momentum=0.5), leaves[:1], 0.125)
        assert calls[3:] == [(24, SK.NO_DECAY, 1, 0.125, 0.5, 0.0, 0)]
        rc[0] = 719  # cudaErrorLaunchFailure
        with pytest.raises(RuntimeError, match="sgdm failed to launch"):
            _update(SGDM(), leaves[:1], 0.25)
    assert SK.sgdm_update.launches == launches + 4
    c = reg.counter("optim.sgdm_leaves")
    assert c.value(route="kernel") == 4 + 1  # not the failed one
    assert c.value(route="plain") == 1


@pytest.mark.parametrize("refused", ["strided", "float16", "grad_dtype", "bf16_moment"])
def test_cuda_leaf_the_kernel_refuses_raises(monkeypatch, refused):
    """A CUDA leaf that ``takes`` refuses raises in ``SGDM.update``: it is not
    sent, not counted, and not handed to the torch ops."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls, plain, _ = _stub_library(monkeypatch)
    reg = MetricsRegistry()
    bf = torch.bfloat16
    with use_registry(reg), FakeTensorMode():
        z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device="cuda")
        leaf = {
            "strided": (z(4, 3, dtype=bf), z(4, 3),
                        torch.empty_strided((4, 3), (6, 2), dtype=bf, device="cuda")),
            "float16": (z(7, dtype=torch.float16), z(7), z(7, dtype=torch.float16)),
            "grad_dtype": (z(6), z(6), z(6, dtype=bf)),
            "bf16_moment": (z(2, 6, dtype=bf), z(2, 6, dtype=bf), z(2, 6, dtype=bf)),
        }[refused]
        assert not SK.takes(*leaf)
        with pytest.raises(ValueError, match="contiguous CUDA"):
            _update(SGDM(momentum=0.9), [leaf], 0.25)
    assert calls == [] and plain == []
    assert reg.counter("optim.sgdm_leaves").series == {}
