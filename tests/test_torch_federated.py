"""The paper-exact engine: the port's ``FaithfulHFL`` against
``repro.core.federated.FaithfulHFL``.

* Bitwise, with ``grad_fn = lambda w, b: b`` (the gradient is the batch,
  exact in both packages): N = 3 clusters x M = 2 MUs, H = 2, the paper's
  φ and β, lr 0.05 and σ = 0.9, 6 steps (3 syncs); the whole state is
  compared as bit patterns after every step, for every Ω impl. N = 3 makes
  the reciprocal multiply of the SBS->MBS mean show, and lr 0.05 the
  fused multiply-add of the SBS update.
* The reference's two equivalences (``tests/test_hfl.py``) on the port.
* The slice: ResNet-18 at width 0.125, 2 x 2, H = 2, batch 4 per MU,
  4 steps with ``pallas``, both packages from the same carried-over
  weights and the same images. The f32 model math sums in another order
  (test_torch_resnet), so the runs agree closely, not bitwise: per-step
  losses measured within 1.1e-7 relative, held to 1e-5; w_ref after the
  last sync measured ||port - ref|| / ||ref - w0|| = 1.1e-4, held to 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HFLConfig as JHFLConfig
from repro.core.federated import FaithfulHFL as JFaithfulHFL
from repro.data import SyntheticImages as JSyntheticImages
from repro.data import partition_iid as j_partition_iid
from repro.models import resnet as JR
from repro.utils.tree import flatten_to_vector as j_flatten
from repro.utils.tree import unflatten_from_vector as j_unflatten
from repro_torch.configs.base import HFLConfig
from repro_torch.core.federated import FaithfulHFL
from repro_torch.data import SyntheticImages, partition_iid
from repro_torch.launch.paper_accuracy import make_fns
from repro_torch.utils.convert import FAITHFUL_KEYS, faithful_state_from_numpy, params_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

LOSS_RTOL, WREF_TOL = 1e-5, 2e-3


@pytest.fixture(autouse=True)
def _aten_convolutions():
    """ATen's CPU convolutions, as ``paper_accuracy.run`` takes on the CPU:
    oneDNN's convolution backward races at 4+ threads."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def _assert_state_bitwise(tsim, jsim, step):
    for key in FAITHFUL_KEYS:
        np.testing.assert_array_equal(_bits(tsim.state[key]), _bits(jsim.state[key]),
                                      err_msg=f"{key} after step {step}")
    assert tsim.state["t"] == int(jsim.state["t"])


@pytest.mark.parametrize("impl", ["topk", "hist", "pallas", "fused"])
def test_engine_state_bitwise(impl):
    N, M, Q = 3, 2, 5000
    tiers = ((M, 1, 0.99, 0.9), (N, 2, 0.9, 0.9, 0.5, 0.2))
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(Q).astype(np.float32)
    kw = dict(lr_schedule=lambda t: 0.05, grad_fn=lambda w, b: b, sparsify_impl=impl)
    jsim = JFaithfulHFL(w0=jnp.asarray(w0), hfl_cfg=JHFLConfig(tiers=tiers), **kw)
    tsim = FaithfulHFL(w0=torch.from_numpy(w0), hfl_cfg=HFLConfig(tiers=tiers), **kw)
    for step in range(6):
        b = rng.standard_normal((N * M, Q)).astype(np.float32)
        jm, tm = jsim.step(jnp.asarray(b)), tsim.step(torch.from_numpy(b))
        _assert_state_bitwise(tsim, jsim, step + 1)
        assert np.isnan(tm["loss"]) and np.isnan(jm["loss"])
        np.testing.assert_allclose(tm["sparse_grad_abs"], jm["sparse_grad_abs"], rtol=1e-5)


def test_engine_resumes_from_carried_state():
    """A reference state carried across mid-run continues bitwise."""
    N, M, Q = 2, 2, 3000
    tiers = ((M, 1, 0.99, 0.9), (N, 2, 0.9, 0.9, 0.5, 0.2))
    rng = np.random.default_rng(3)
    kw = dict(lr_schedule=lambda t: 0.05, grad_fn=lambda w, b: b, sparsify_impl="topk")
    jsim = JFaithfulHFL(w0=jnp.asarray(rng.standard_normal(Q).astype(np.float32)),
                        hfl_cfg=JHFLConfig(tiers=tiers), **kw)
    jsim.step(jnp.asarray(rng.standard_normal((N * M, Q)).astype(np.float32)))
    tsim = FaithfulHFL(w0=torch.zeros(Q), hfl_cfg=HFLConfig(tiers=tiers), **kw)
    tsim.state = faithful_state_from_numpy(jax.tree.map(np.asarray, jsim.state), "cpu")
    assert tsim.state["t"] == 1
    b = rng.standard_normal((N * M, Q)).astype(np.float32)  # step 2 syncs
    jsim.step(jnp.asarray(b))
    tsim.step(torch.from_numpy(b))
    _assert_state_bitwise(tsim, jsim, 2)


def _quadratic():
    Q = 48
    rng = np.random.default_rng(0)
    A = torch.from_numpy((rng.standard_normal((Q, Q)) * 0.1 + np.eye(Q)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal(Q).astype(np.float32))

    def grad_fn(w, batch):
        return A.T @ (A @ (w - target)) + 0.01 * batch

    return Q, grad_fn


def _dense_tiers(mus, clusters, period):
    return ((mus, 1, 0.0, 0.0), (clusters, period, 0.0, 0.0, 0.0, 0.0))


def test_phi0_H1_is_vanilla_sgd():
    Q, grad_fn = _quadratic()
    sim = FaithfulHFL(grad_fn=grad_fn, w0=torch.zeros(Q),
                      hfl_cfg=HFLConfig(tiers=_dense_tiers(2, 1, 1)),
                      lr_schedule=lambda t: 0.05)
    w = torch.zeros(Q)
    rng = np.random.default_rng(1)
    for _ in range(8):
        b = torch.from_numpy(rng.standard_normal((2, Q)).astype(np.float32))
        sim.step(b)
        w = w - 0.05 * torch.stack([grad_fn(w, bi) for bi in b]).mean(0)
    np.testing.assert_allclose(sim.cluster_models[0].numpy(), w.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_phi0_is_periodic_averaging():
    Q, grad_fn = _quadratic()
    sim = FaithfulHFL(grad_fn=grad_fn, w0=torch.zeros(Q),
                      hfl_cfg=HFLConfig(tiers=_dense_tiers(1, 3, 2)),
                      lr_schedule=lambda t: 0.05)
    wn = torch.zeros(3, Q)
    rng = np.random.default_rng(2)
    for t in range(6):
        b = torch.from_numpy(rng.standard_normal((3, Q)).astype(np.float32))
        sim.step(b)
        wn = wn - 0.05 * torch.stack([grad_fn(w, bi) for w, bi in zip(wn, b)])
        if (t + 1) % 2 == 0:
            wn = wn.mean(0, keepdim=True).repeat(3, 1)
    np.testing.assert_allclose(sim.cluster_models.numpy(), wn.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_resnet_slice_matches_reference():
    width, bpm, steps = 0.125, 4, 4
    tiers = ((2, 1, 0.99, 0.9), (2, 2, 0.9, 0.9, 0.5, 0.2))
    jp, js = jax.jit(JR.init_resnet18, static_argnames=("num_classes", "width"))(
        jax.random.PRNGKey(0), width=width)
    jw0, aux = j_flatten(jp)

    def jloss(w, batch):
        x, y = batch
        logits, _ = JR.resnet18_forward(j_unflatten(w, aux), js, x, train=True)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1).mean()

    tw0, tloss, _ = make_fns(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                             params_from_numpy(jax.tree.map(np.asarray, js), "cpu"))
    kw = dict(lr_schedule=lambda t: 0.05, sparsify_impl="pallas")
    jsim = JFaithfulHFL(w0=jw0, hfl_cfg=JHFLConfig(tiers=tiers), loss_fn=jloss, **kw)
    tsim = FaithfulHFL(w0=tw0, hfl_cfg=HFLConfig(tiers=tiers), loss_fn=tloss, **kw)

    xs, ys = SyntheticImages(seed=3).sample(512)
    jx, jy = JSyntheticImages(seed=3).sample(512)
    np.testing.assert_array_equal(xs, jx)
    shards = partition_iid(512, 4, np.random.default_rng(1))
    for a, b in zip(shards, j_partition_iid(512, 4, np.random.default_rng(1))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    jl, tl = [], []
    for _ in range(steps):
        idx = np.stack([rng.choice(s, bpm) for s in shards])
        jl.append(jsim.step((jnp.asarray(xs[idx]), jnp.asarray(ys[idx])))["loss"])
        tl.append(tsim.step((torch.from_numpy(xs[idx]), torch.from_numpy(ys[idx])))["loss"])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jr, tr = np.asarray(jsim.global_model), tsim.global_model.numpy()
    assert np.linalg.norm(tr - jr) / np.linalg.norm(jr - np.asarray(jw0)) <= WREF_TOL
    k = round(0.01 * tw0.numel())
    assert all(int((r == 0).sum()) >= k for r in tsim.state["u"])
