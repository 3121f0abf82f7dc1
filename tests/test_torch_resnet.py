"""ResNet-18 at width 0.125 (Q = 176,402) and batch 4: the port against
``repro.models.resnet`` on the same weights, carried across through numpy.

The flat vector is bitwise the reference's (same leaves, same order).
The f32 convolutions, means and matmuls sum in another order in the two
frameworks, so values agree to f32 rounding, not bitwise. Tolerances, as
a fraction of the array's largest magnitude, set from the measured gap:
logits measured 1.5e-6 (train) and 1.6e-7 (eval), held to 1e-5; the new
BatchNorm state measured 2.3e-6, held to 2e-5; the flat gradient of the
cross-entropy measured 3.1e-6, held to 3e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import resnet as JR
from repro.utils.tree import flatten_to_vector as j_flatten
from repro.utils.tree import unflatten_from_vector as j_unflatten
from repro_torch.models import resnet as TR
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import flatten_to_vector, tree_leaves, unflatten_from_vector

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

WIDTH, BATCH = 0.125, 4
LOGIT_TOL, BN_TOL, GRAD_TOL = 1e-5, 2e-5, 3e-5


@pytest.fixture(autouse=True)
def _aten_convolutions():
    """ATen's CPU convolutions, as ``paper_accuracy.run`` takes on the CPU:
    oneDNN's convolution backward races at 4+ threads."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def nets():
    jp, js = jax.jit(JR.init_resnet18, static_argnames=("num_classes", "width"))(
        jax.random.PRNGKey(0), width=WIDTH)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return jp, js, tp, ts, x, y


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_flat_vector_order_and_offsets(nets):
    jp, _, tp, _, _, _ = nets
    jv, (_, jshapes, _, jsizes) = j_flatten(jp)
    tv, (_, tshapes, _, tsizes) = flatten_to_vector(tp)
    assert tv.numel() == jv.size == 176402
    assert [tuple(s) for s in jshapes] == tshapes and list(jsizes) == tsizes
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    back = unflatten_from_vector(tv, flatten_to_vector(tp)[1])
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert a._base is tv and torch.equal(a, b)  # views of the vector


def test_forward_and_bn_state_match_reference(nets):
    jp, js, tp, ts, x, _ = nets
    jl, jn = JR.resnet18_forward(jp, js, jnp.asarray(x), True)
    tl, tn = TR.resnet18_forward(tp, ts, torch.from_numpy(x), True)
    assert _rel(jl, tl.numpy()) <= LOGIT_TOL
    for a, b in zip(jax.tree.leaves(jn), tree_leaves(tn)):
        assert _rel(a, b.numpy()) <= BN_TOL
    # eval on the updated running stats (the reference's own new state)
    tn_ref = params_from_numpy(jax.tree.map(np.asarray, jn), "cpu")
    jl, je = JR.resnet18_forward(jp, jn, jnp.asarray(x), False)
    tl, te = TR.resnet18_forward(tp, tn_ref, torch.from_numpy(x), False)
    assert _rel(jl, tl.numpy()) <= LOGIT_TOL
    assert all(a is b for a, b in zip(tree_leaves(te), tree_leaves(tn_ref)))


def test_flat_gradient_matches_reference(nets):
    jp, js, tp, ts, x, y = nets
    jv, jaux = j_flatten(jp)

    def jloss(w):
        logits, _ = JR.resnet18_forward(j_unflatten(w, jaux), js, jnp.asarray(x), True)
        lp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1).mean()

    jg = np.asarray(jax.jit(jax.grad(jloss))(jv))
    tv, taux = flatten_to_vector(tp)
    w = tv.clone().requires_grad_(True)
    logits, _ = TR.resnet18_forward(unflatten_from_vector(w, taux), ts,
                                    torch.from_numpy(x), True)
    loss = -torch.log_softmax(logits, -1).gather(1, torch.from_numpy(y).long()[:, None]).mean()
    (tg,) = torch.autograd.grad(loss, w)
    assert tg.shape == (176402,)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jv)), rtol=1e-6)
    assert _rel(jg, tg.numpy()) <= GRAD_TOL


def test_stride2_conv_pads_like_xla_same(nets):
    """``s1b0c1`` (3x3, stride 2) alone: XLA's "SAME" pads (0, 1); a port
    with ``padding=1`` keeps the shape and shifts every output."""
    jp, _, tp, _, _, _ = nets
    h = np.random.default_rng(1).standard_normal((BATCH, 16, 16, 8)).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(h), jp["s1b0c1"], 2))
    x = torch.from_numpy(h).permute(0, 3, 1, 2)
    got = TR.conv(x, tp["s1b0c1"], 2).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (BATCH, 8, 8, 16)
    assert _rel(want, got) <= LOGIT_TOL
    naive = F.conv2d(x, tp["s1b0c1"].permute(3, 2, 0, 1), stride=2, padding=1)
    assert _rel(want, naive.permute(0, 2, 3, 1).numpy()) > 0.1
