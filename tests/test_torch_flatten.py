"""Flat layout parity: flat index i names the same model entry in the port
as in ``repro.utils.flatten`` (bitwise, on the reduced olmo-1b tree)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.transformer import init_model
from repro.utils import flatten as jfl
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_flatten, tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

CFG = get_config("olmo-1b").reduced()


@pytest.fixture(scope="module")
def trees():
    ref = init_model(jax.random.PRNGKey(0), CFG)
    np_tree = jax.tree.map(np.asarray, ref)
    return ref, params_from_numpy(np_tree, "cpu")


def test_leaf_order_is_jax_order(trees):
    ref, port = trees
    paths = [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert list(tree_flatten(port)[1]) == paths
    assert ("blocks", "norm1", "_np") in paths  # the LN placeholder is part of Q


def test_pack_is_bitwise_and_offsets_match(trees):
    ref, port = trees
    jvec, jspec = jfl.pack(ref)
    tvec, tspec = tfl.pack(port)
    assert tspec.offsets == jspec.offsets and tspec.total == jspec.total
    assert tspec.shapes == jspec.shapes
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))


def test_pack_stacked_and_unpack_roundtrip(trees):
    ref, port = trees
    rng = np.random.default_rng(0)
    stacked_np = jax.tree.map(
        lambda p: np.stack([np.asarray(p, np.float32) + rng.standard_normal(p.shape).astype(np.float32)
                            for _ in range(3)]), ref)
    jmat, _ = jfl.pack_stacked(jax.tree.map(jax.numpy.asarray, stacked_np))
    tst = params_from_numpy(stacked_np, "cpu")
    tmat, tspec = tfl.pack_stacked(tst)
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    back = tfl.unpack_stacked(tmat, tspec)
    for a, b in zip(tree_leaves(back), tree_leaves(tst)):
        assert torch.equal(a, b)
    vec, spec = tfl.pack(port)
    for a, b in zip(tree_leaves(tfl.unpack(vec, spec)), tree_leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flat_backed_trees_are_found_again(trees):
    _, port = trees
    spec = tfl.spec_of(port)
    flat, tree = tfl.flat_backed_zeros(spec, None, torch.float32, "cpu")
    assert tfl.backing(tree, spec) is flat
    flat2, tree2 = tfl.flat_backed_zeros(spec, 3, torch.float32, "cpu")
    assert tfl.backing(tree2, spec, rows=3) is flat2
    tree_leaves(tree2)[0][1].fill_(2.0)  # a leaf write lands in the buffer
    assert float(flat2[1, spec.leaf_slice(0)].sum()) == 2.0 * spec.sizes[0]
    assert tfl.backing(port, spec) is None  # separately allocated leaves
    # the padded layout (shards > 1) is ported: its buffers are found too
    spec3 = tfl.spec_of(port, shards=3)
    flat3, tree3 = tfl.flat_backed_zeros(spec3, 2, torch.float32, "cpu")
    assert flat3.shape == (2, spec3.padded_total)
    assert tfl.backing(tree3, spec3, rows=2) is flat3
