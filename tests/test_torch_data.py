"""The non-IID data path on the port against the reference: the label-
sorted and Dirichlet partitions and ``FederatedBatcher`` are numpy on both
sides, so shards and draws are EQUAL for the same seed (an empty shard, which
draws from the global pool, included); the non-IID twin
(``launch.noniid_hfl``) at width 0.125 over 2 steps against the example's
loop on the reference: per-step losses rtol 1e-5 (the f32 ResNet math sums
in another order, ``tests/test_torch_federated.py``), top-1 within one of
the 512 test images.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HFLConfig as JHFLConfig
from repro.core.federated import FaithfulHFL as JFaithfulHFL
from repro.data import FederatedBatcher as JBatcher
from repro.data import SyntheticImages as JSyntheticImages
from repro.data import cluster_batches as j_cluster_batches
from repro.data import partition_dirichlet as j_dirichlet
from repro.data import partition_iid as j_iid
from repro.data import partition_label_sorted as j_label_sorted
from repro.models import resnet as JR
from repro.utils.tree import flatten_to_vector as j_flatten
from repro.utils.tree import unflatten_from_vector as j_unflatten
from repro_torch.data import (
    FederatedBatcher, cluster_batches, partition_dirichlet, partition_label_sorted,
)
from repro_torch.launch import noniid_hfl
from repro_torch.launch.paper_accuracy import make_fns
from repro_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)


def _labels(n=600, seed=0):
    return np.random.default_rng(seed).integers(0, 10, n)


@pytest.mark.parametrize("K", [1, 7, 28])
def test_label_sorted_partition_equals_reference(K):
    labels = _labels()
    for a, b in zip(partition_label_sorted(labels, K), j_label_sorted(labels, K)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha,K", [(0.3, 28), (0.05, 12), (5.0, 4)])
def test_dirichlet_partition_equals_reference(alpha, K):
    labels = _labels(300)
    got = partition_dirichlet(labels, K, alpha=alpha, rng=np.random.default_rng(1))
    want = j_dirichlet(labels, K, alpha=alpha, rng=np.random.default_rng(1))
    assert len(got) == len(want) == K
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(len(labels)))
    if alpha == 0.05:  # small α starves an MU of every class
        assert any(len(s) == 0 for s in got)


def test_batcher_draws_equal_reference_with_an_empty_shard():
    labels = _labels(300)
    # seed 0: one MU gets nothing, two fewer rows than a batch
    shards = partition_dirichlet(labels, 12, alpha=0.05, rng=np.random.default_rng(0))
    assert any(len(s) == 0 for s in shards) and any(0 < len(s) < 8 for s in shards)
    xs = np.arange(300 * 3, dtype=np.float32).reshape(300, 3)
    got = FederatedBatcher((xs, labels), shards, batch_size=8, seed=4)
    want = JBatcher((xs, labels), shards, batch_size=8, seed=4)
    for _ in range(3):
        (gx, gy), (wx, wy) = next(got), next(want)
        assert gx.shape == (12, 8, 3) and gy.shape == (12, 8)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    single = FederatedBatcher((xs,), shards, batch_size=8, seed=4)
    np.testing.assert_array_equal(next(single), next(JBatcher((xs,), shards, 8, 4)))
    mu = next(got)[0]
    np.testing.assert_array_equal(cluster_batches(mu, 3), j_cluster_batches(mu, 3))
    assert cluster_batches(mu, 3).shape == (3, 32, 3)


def test_noniid_twin_matches_the_example_on_the_reference():
    width, steps = 0.125, 2
    jp, js = jax.jit(JR.init_resnet18, static_argnames=("num_classes", "width"))(
        jax.random.PRNGKey(0), width=width)
    jw0, aux = j_flatten(jp)

    def jloss(w, batch):
        x, y = batch
        logits, _ = JR.resnet18_forward(j_unflatten(w, aux), js, x, train=True)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1).mean()

    # the example's loop (examples/noniid_hfl.py) with the loss reported
    data = JSyntheticImages(seed=3)
    xs, ys = data.sample(4096)
    xt, yt = data.sample(512, np.random.default_rng(9))
    hfl = JHFLConfig(tiers=((4, 1, 0.99, 0.9), (7, 4, 0.9, 0.9, 0.5, 0.2)))
    K = hfl.total_mus
    splits = {
        "iid": j_iid(len(xs), K, np.random.default_rng(1)),
        "label-sorted (paper)": j_label_sorted(ys, K),
        "dirichlet(0.3)": j_dirichlet(ys, K, alpha=0.3, rng=np.random.default_rng(1)),
    }
    want = {}
    for name, shards in splits.items():
        sim = JFaithfulHFL(loss_fn=jloss, w0=jw0, hfl_cfg=hfl, lr_schedule=lambda t: 0.05)
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(steps):
            idx = np.stack([rng.choice(s, 16, replace=len(s) < 16) for s in shards])
            losses.append(sim.step((jnp.asarray(xs[idx]), jnp.asarray(ys[idx])))["loss"])
        logits, _ = JR.resnet18_forward(j_unflatten(sim.global_model, aux), js,
                                        jnp.asarray(xt), train=True)
        want[name] = (losses, float((logits.argmax(-1) == jnp.asarray(yt)).mean()))

    fns = make_fns(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                   params_from_numpy(jax.tree.map(np.asarray, js), "cpu"))
    got = noniid_hfl.run(steps, device="cpu", fns=fns)
    assert list(got) == list(want) == list(noniid_hfl.SPLITS)
    for name, (losses, acc) in want.items():
        np.testing.assert_allclose(got[name]["losses"], losses, rtol=1e-5, err_msg=name)
        assert abs(got[name]["acc"] - acc) <= 1 / 512, name
