"""``bitpack``'s plain version against the reference Pallas kernel in
interpret mode, and the flat-mask glue (``bitpack_bytes``,
``bitmap_payload``) and the bitmap codec's kernel path against numpy and
against the reference's. Bytes are compared by value (the reference keeps
one byte per int32 lane, the port writes uint8); popcounts exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codecs import get_codec as jget_codec
from repro.kernels.bitpack import kernel as JK
from repro.kernels.bitpack import ops as jops
from repro_torch.comm.codecs import get_codec
from repro_torch.kernels.bitpack import kernel as TK
from repro_torch.kernels.bitpack import ops as tops
from repro_torch.kernels.bitpack.ref import bitpack_ref

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)


def _mask(n, seed, subnormals=False):
    """A float mask with set entries, zeros, -0.0, NaN and +-inf among them
    (and subnormals if asked)."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random(n) < 0.3, rng.standard_normal(n), 0.0).astype(np.float32)
    odd = [np.nan, -0.0, np.inf, -np.inf, 0.0, -np.nan]
    if subnormals:
        odd += [1e-45, -1e-40]
    m[:min(n, len(odd))] = np.array(odd, np.float32)[:n]
    return m


def _tiles(m):
    n = m.size
    pad = (-n) % (TK.BLOCK_ROWS * TK.BLOCK_COLS)
    return np.pad(m, (0, pad)).reshape(-1, TK.BLOCK_COLS)


@pytest.mark.parametrize("n", [5, 300, 4096, 262147])
def test_bitpack_plain_vs_pallas(n):
    tiles = _tiles(_mask(n, n))
    jb, jc = JK.bitpack(jnp.asarray(tiles), interpret=True)
    tb, tc = TK.bitpack(torch.from_numpy(tiles))
    assert tb.dtype == torch.uint8 and tb.shape == tuple(jb.shape)
    assert tc.dtype == torch.int32 and tc.shape == tuple(jc.shape)
    np.testing.assert_array_equal(tb.numpy().astype(np.int32), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n", [5, 300, 4096, 262147])
def test_bitpack_bytes_matches_packbits(n):
    """Subnormals are set, as in numpy (the reference's jitted compare
    flushes them to zero on XLA's CPU)."""
    m = _mask(n, n + 1, subnormals=True)
    want = np.packbits(m != 0.0, bitorder="little").tobytes()
    assert want == bitpack_ref(m).tobytes()
    assert tops.bitpack_bytes(m, device="cpu") == want
    assert tops.bitpack_bytes(torch.from_numpy(m)) == want
    assert tops.bitpack_bytes(torch.from_numpy(m != 0)) == want  # bool masks


@pytest.mark.parametrize("case", ["all-zero", "all-one", "mixed"])
def test_bitpack_counts_are_popcounts(case):
    n = 2 * TK.BLOCK_ROWS * TK.BLOCK_COLS + 3
    m = {"all-zero": np.zeros(n, np.float32), "all-one": np.ones(n, np.float32),
         "mixed": _mask(n, 3, subnormals=True)}[case]
    tiles = _tiles(m)
    _, counts = TK.bitpack(torch.from_numpy(tiles))
    want = (tiles != 0).reshape(counts.shape[0], -1).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy()[:, 0], want)


@pytest.mark.parametrize("n", [1000, 262147])
def test_bitmap_payload_matches_reference(n):
    rng = np.random.default_rng(6)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.9] = 0.0
    x[:3] = [np.nan, -0.0, np.inf]
    packed, vals = tops.bitmap_payload(torch.from_numpy(x))
    jpacked, jvals = jops.bitmap_payload(x)
    assert packed == jpacked
    np.testing.assert_array_equal(vals, np.asarray(jvals))
    np.testing.assert_array_equal(vals, x[x != 0.0])
    packed, vals = tops.bitmap_payload(np.zeros(17, np.float32), device="cpu")
    assert packed == b"\x00\x00\x00" and vals.shape == (0,)


@pytest.mark.parametrize("name", ["bitmap", "bitmap-q8"])
def test_bitmap_codec_kernel_path_identical(name):
    rng = np.random.default_rng(5)
    size, k = 3000, 123
    i = np.sort(rng.choice(size, k, replace=False)).astype(np.int32)
    i[1] = i[0]  # a duplicate index: coalesced by summation
    v = rng.normal(size=k).astype(np.float32)
    got = get_codec(name).encode(v, i, size, impl="pallas", device="cpu")
    np.testing.assert_array_equal(got, get_codec(name).encode(v, i, size))
    np.testing.assert_array_equal(
        got, jget_codec(name).encode(v, i, size, impl="pallas"))
