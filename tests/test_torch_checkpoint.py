"""Checkpoints of the port against the reference's, bit for bit.

  * the hand-written msgpack subset (``repro_torch.checkpoint``'s header
    functions, its streamed ``write_payload`` and its reader) against
    ``msgpack.packb(..., use_bin_type=True)`` / ``unpackb`` byte for byte,
    at every size boundary of every header (± 1) and on random nested
    objects;
  * an ``HFLState`` after 2 train steps and a sync of the reference (SGDM
    and AdamW, bf16 params), carried across with ``utils.convert``: both
    packages write byte-identical files (equal sha256), each restores the
    other's file bit for bit, the port in place into ``hfl_init``'s
    flat-backed buffers (``flat_shards`` 2 and 3: Q = 22,496 splits in 2
    without a pad, in 3 with one), which the sync still finds; the
    restored state's next period (2 steps and a sync) equals the unsaved
    state's bit for bit;
  * rotation to ``keep=3``, ``latest_step``, and the reference's failures
    (no checkpoint, a leaf-count mismatch, a leaf too large for a bin);
    a file that does not fit the target (a leaf of another shape, a
    truncated file, extra bytes) raises and leaves the target unchanged.
Tolerance: none; every comparison is exact.
"""
import dataclasses
import hashlib
import io
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro.checkpoint import msgpack_ckpt as jck
from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import hfl as jhfl
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import init_model
from repro.optim import SGDM as JSGDM
from repro.optim import AdamW as JAdamW
from repro.optim import constant_lr as j_constant_lr
from repro_torch.checkpoint import msgpack_ckpt as tck
from repro_torch.configs.base import HFLConfig as THFLConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import hfl as thfl
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.optim import SGDM as TSGDM
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim import constant_lr as t_constant_lr
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TINY = JModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                    num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=61,
                    dtype="bfloat16", remat=False)
TIERS = ((2, 1, 0.9, 0.9), (2, 2, 0.9, 0.9, 0.5, 0.2))  # N = 2 clusters, H = 2
B, T = 2, 8

# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------

_EDGES = (0, 1, 15, 16, 17, 31, 32, 33, 127, 128, 129, 255, 256, 257,
          65535, 65536, 65537)


def _packb(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _enc(obj) -> bytes:
    """``obj`` of the subset encoded with the module's header functions."""
    if isinstance(obj, dict):
        return tck.map_header(len(obj)) + b"".join(_enc(k) + _enc(v)
                                                   for k, v in obj.items())
    if isinstance(obj, list):
        return tck.array_header(len(obj)) + b"".join(_enc(v) for v in obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return tck.str_header(len(b)) + b
    if isinstance(obj, bytes):
        return tck.bin_header(len(obj)) + obj
    return tck.uint_header(obj)


def _dec(data: bytes):
    """``data`` decoded with the module's reader, which must use it all."""
    f = io.BytesIO(data)
    out = tck._Reader(f).obj()
    assert f.read() == b""
    return out


@pytest.mark.parametrize("n", _EDGES + (50303, 50304, 50305, (1 << 32) - 1,
                                        1 << 32, (1 << 64) - 1))
def test_uint_headers_match_packb(n):
    assert tck.uint_header(n) == _packb(n)
    assert _dec(_packb(n)) == n


@pytest.mark.parametrize("n", _EDGES)
def test_str_bin_array_map_headers_match_packb(n):
    for obj in ("s" * n, b"\x07" * n, [3] * n, {f"{i:06d}": i for i in range(n)}):
        assert _enc(obj) == _packb(obj), (type(obj), n)
        assert _dec(_packb(obj)) == obj


def test_dtype_string_is_a_fixstr():
    assert tck._str("bfloat16") == _packb("bfloat16") == b"\xa8bfloat16"


_OBJ = hst.recursive(
    hst.integers(0, (1 << 64) - 1) | hst.text(max_size=40) | hst.binary(max_size=300),
    lambda c: hst.lists(c, max_size=20) | hst.dictionaries(hst.text(max_size=8), c,
                                                          max_size=20),
    max_leaves=40)


@settings(max_examples=60, deadline=None)
@given(_OBJ)
def test_property_packb_roundtrip(obj):
    assert _enc(obj) == _packb(obj)
    assert _dec(_packb(obj)) == obj


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 16383, 16384, 16385])
def test_write_payload_matches_packb(n):
    """The streamed payload equals ``msgpack.packb`` of the reference's
    one-shot ``{"leaves": [...]}`` at the bin8 / bin16 / bin32 edges of a
    leaf's data (f32: 4 bytes an entry), and the reader decodes it."""
    x = torch.arange(n, dtype=torch.float32).reshape(1, n)
    tree = {"b": x.bfloat16(), "a": torch.tensor([n, 1], dtype=torch.int64), "c": None}
    buf = io.BytesIO()
    assert tck.write_payload(buf, tree) == len(buf.getvalue())
    want = {"leaves": [
        {"dtype": "int32", "shape": [2], "data": np.array([n, 1], np.int32).tobytes()},
        {"dtype": "bfloat16", "shape": [1, n],
         "data": x.bfloat16().float().numpy().tobytes()}]}
    assert buf.getvalue() == _packb(want)
    assert _dec(buf.getvalue()) == want


def test_leaf_over_a_bin_raises_before_writing(tmp_path):
    """2**32 - 1 bytes is a bin32; one more is no msgpack bin (the
    reference's ``packb`` raises): checked on the header and on a meta
    leaf of 2**32 + 4 bytes, which allocates nothing, and no file (not
    even the temporary one) is left behind."""
    assert tck.bin_header((1 << 32) - 1) == b"\xc6\xff\xff\xff\xff"
    with pytest.raises(ValueError, match="bin"):
        tck.bin_header(1 << 32)
    with pytest.raises(ValueError, match="bin"):
        tck.save_checkpoint(str(tmp_path), 1, {"w": torch.empty((1 << 30) + 1,
                                                                device="meta")})
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# HFL states, both packages
# ---------------------------------------------------------------------------


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, (2, B, T)).astype(np.int32)
            for _ in range(steps)]


@pytest.fixture(scope="module", params=["sgdm", "adamw"])
def ref_state(request):
    """The reference's state after 2 train steps and a sync."""
    opt = JSGDM(momentum=0.9) if request.param == "sgdm" else JAdamW()
    hfl = JHFLConfig(tiers=TIERS)
    state = jhfl.hfl_init(init_model(jax.random.PRNGKey(0), TINY), opt, hfl)
    step = jax.jit(jhfl.make_cluster_train_step(j_loss_fn(TINY), opt,
                                                j_constant_lr(0.1)))
    for toks in _batches(1, 2):
        state, _ = step(state, {"tokens": jnp.asarray(toks)})
    state = jax.jit(jhfl.make_sync(jhfl.SyncPlan.from_config(hfl)))(state)
    return request.param, state


def _port_opt(name):
    return TSGDM(momentum=0.9) if name == "sgdm" else TAdamW()


def _fresh(name, tstate, shards=1):
    """A port target: ``hfl_init``'s flat-backed state of the same tree."""
    hfl = THFLConfig(tiers=TIERS, flat_shards=shards,
                     omega_impl="fused" if shards > 1 else "topk")
    params = tree_map(lambda p: torch.zeros_like(p[0]), tstate.params)
    return hfl, thfl.hfl_init(params, _port_opt(name), hfl)


def _copy_into(dst, src):
    for f in ("params", "opt", "w_ref", "eps", "e"):
        for a, b in zip(tree_leaves(getattr(dst, f)), tree_leaves(getattr(src, f)),
                        strict=True):
            a.copy_(b)
    return dst._replace(step=src.step)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_port_equal(a, b):
    for f in ("params", "opt", "w_ref", "eps", "e"):
        for x, y in zip(tree_leaves(getattr(a, f)), tree_leaves(getattr(b, f)),
                        strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), f
    assert a.step == b.step


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_both_packages_write_the_same_file(ref_state, tmp_path):
    name, jstate = ref_state
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jpath = jck.save_checkpoint(str(tmp_path / "ref"), 3, jstate._asdict())
    tpath = tck.save_checkpoint(str(tmp_path / "port"), 3, tstate._asdict())
    assert os.path.basename(tpath) == "ckpt_00000003.msgpack"
    assert _sha(jpath) == _sha(tpath)
    leaves = msgpack.unpackb(open(tpath, "rb").read(), raw=False)["leaves"]
    dtypes = {l["dtype"] for l in leaves}
    assert "bfloat16" in dtypes and "int64" not in dtypes
    # the padded layout holds the same leaves: the same file
    _, padded = _fresh(name, tstate, shards=3)
    padded = _copy_into(padded, tstate)
    p2 = tck.save_checkpoint(str(tmp_path / "padded"), 3, padded._asdict())
    assert _sha(p2) == _sha(jpath)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_port_restores_the_reference_file_in_place(ref_state, tmp_path, shards):
    name, jstate = ref_state
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jck.save_checkpoint(str(tmp_path), 3, jstate._asdict())
    hfl, target = _fresh(name, tstate, shards)
    spec = tfl.spec_of(target.w_ref, shards=shards)
    bufs = [tfl.backing(target.w_ref, spec), tfl.backing(target.e, spec),
            tfl.backing(target.eps, spec, rows=2)]
    tree, step = tck.restore_checkpoint(str(tmp_path), target._asdict())
    restored = thfl.HFLState(**tree)
    assert step == 3
    _assert_port_equal(restored, tstate)
    # written in place: the sync finds the same padded flat buffers
    again = [tfl.backing(restored.w_ref, spec), tfl.backing(restored.e, spec),
             tfl.backing(restored.eps, spec, rows=2)]
    assert all(b is not None and a.data_ptr() == b.data_ptr()
               for a, b in zip(bufs, again))
    assert spec.pad == (1 if shards == 3 else 0)
    if spec.pad:  # the padded tail is in no leaf and stays zero
        assert not again[0][spec.total:].any() and not again[2][:, spec.total:].any()


def test_reference_restores_the_port_file(ref_state, tmp_path):
    name, jstate = ref_state
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tck.save_checkpoint(str(tmp_path), 3, tstate._asdict())
    target = jax.tree.map(jnp.zeros_like, jstate._asdict())
    tree, step = jck.restore_checkpoint(str(tmp_path), target)
    assert step == 3
    want = jstate._asdict()
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_restored_state_resumes_like_the_unsaved_one(ref_state, tmp_path, shards):
    """2 train steps and a sync from the restored state equal the same
    period from the state that was never saved, bit for bit."""
    name, jstate = ref_state
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    hfl, unsaved = _fresh(name, tstate, shards)
    unsaved = _copy_into(unsaved, tstate)
    tck.save_checkpoint(str(tmp_path), 3, unsaved._asdict())
    _, target = _fresh(name, tstate, shards)
    restored = thfl.HFLState(**tck.restore_checkpoint(str(tmp_path), target._asdict())[0])
    cfg = TModelConfig(**dataclasses.asdict(TINY))
    opt = _port_opt(name)
    step = thfl.make_cluster_train_step(t_loss_fn(cfg), opt, t_constant_lr(0.1))
    outs = []
    for state in (unsaved, restored):
        sync = thfl.make_sync(thfl.SyncPlan(hfl))
        for toks in _batches(2, 2):
            state, _ = step(state, {"tokens": torch.from_numpy(toks).long()})
        outs.append(sync(state))
    _assert_port_equal(outs[1], outs[0])
    assert outs[0].step == jstate.step + 2


def test_rotation_latest_step_and_failures(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": 5}
    for s in (1, 2, 3, 4, 5):
        tck.save_checkpoint(d, s, tree)
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.msgpack" for s in (3, 4, 5)]
    assert tck.latest_step(d) == 5 == jck.latest_step(d)
    assert tck.latest_step(str(tmp_path / "none")) is None
    target = {"w": torch.zeros(2, 3), "n": 0}
    out, step = tck.restore_checkpoint(d, target, step=3)
    assert step == 3 and out["n"] == 5 and out["w"] is target["w"]
    assert torch.equal(target["w"], tree["w"])
    with pytest.raises(AssertionError, match="checkpoint/target mismatch"):
        tck.restore_checkpoint(d, {"w": torch.zeros(2, 3)})
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tck.restore_checkpoint(str(tmp_path / "empty"), target)


def _bad_files():
    """(name, how to spoil a good file) pairs."""
    def shape(d, tree):
        tck.save_checkpoint(d, 1, {**tree, "z": torch.ones(3, 2)})

    def truncate(d, tree):
        path = tck.save_checkpoint(d, 1, tree)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 1)

    def extra(d, tree):
        path = tck.save_checkpoint(d, 1, tree)
        with open(path, "ab") as f:
            f.write(b"\x00")

    return [("shape", shape, "shape"), ("truncated", truncate, "truncated"),
            ("extra", extra, "extra data")]


@pytest.mark.parametrize("name,spoil,match", _bad_files(),
                         ids=[b[0] for b in _bad_files()])
def test_bad_file_leaves_the_target_unchanged(tmp_path, name, spoil, match):
    """The whole file is checked before the first leaf is written: a file
    whose LAST leaf has another shape than the target's, one cut short by a
    byte, or one with a byte after the payload raises ``ValueError``, and
    every leaf of the target (the flat-backed ones first in the order)
    holds its bits."""
    hfl = THFLConfig(tiers=TIERS)
    params = {"a": torch.zeros(4, 5), "b": torch.zeros(7)}
    target = thfl.hfl_init(params, TSGDM(momentum=0.9), hfl)._asdict()
    target["z"] = torch.zeros(2, 3)
    gen = torch.Generator().manual_seed(3)
    for leaf in tree_leaves({k: v for k, v in target.items() if k != "step"}):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [l.clone() for l in tree_leaves({k: v for k, v in target.items()
                                              if k != "step"})]
    saved = {k: (v if k == "step" else tree_map(lambda t: t + 1, v))
             for k, v in target.items()}
    saved["step"] = 9
    spoil(str(tmp_path), saved)
    with pytest.raises(ValueError, match=match):
        tck.restore_checkpoint(str(tmp_path), target)
    after = tree_leaves({k: v for k, v in target.items() if k != "step"})
    assert all(torch.equal(_as_bits(a), _as_bits(b)) for a, b in zip(after, before,
                                                                      strict=True))
    assert target["step"] == 0


def _as_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_leaf_kinds_round_trip(tmp_path):
    """Strided, 0-d, bool, int64 (written as int32), bf16 (written as f32)
    and Python int leaves, ``None`` dropped: the reference's restore reads
    the port's file, and the port's restores it in place."""
    base = torch.arange(12, dtype=torch.float32)
    tree = {"s": base[::3], "z": torch.tensor(2.5), "b": torch.tensor([True, False]),
            "t": torch.tensor([3, 4], dtype=torch.int64), "h": base.reshape(3, 4).bfloat16(),
            "n": 7, "none": None}
    tck.save_checkpoint(str(tmp_path), 1, tree)
    leaves = msgpack.unpackb(open(tmp_path / "ckpt_00000001.msgpack", "rb").read(),
                             raw=False)["leaves"]
    assert [l["dtype"] for l in leaves] == ["bool", "bfloat16", "int32", "float32",
                                            "int32", "float32"]
    jtarget = {"s": jnp.zeros(4), "z": jnp.zeros(()), "b": jnp.zeros(2, bool),
               "t": jnp.zeros(2, jnp.int32), "h": jnp.zeros((3, 4), jnp.bfloat16),
               "n": jnp.zeros((), jnp.int32), "none": None}
    jtree, _ = jck.restore_checkpoint(str(tmp_path), jtarget)
    assert np.asarray(jtree["s"]).tolist() == [0.0, 3.0, 6.0, 9.0]
    assert int(jtree["n"]) == 7 and np.asarray(jtree["t"]).tolist() == [3, 4]
    target = {"s": torch.zeros(12)[::3], "z": torch.zeros(()), "b": torch.zeros(2, dtype=bool),
              "t": torch.zeros(2, dtype=torch.int64), "h": torch.zeros(3, 4).bfloat16(),
              "n": 0, "none": None}
    out, _ = tck.restore_checkpoint(str(tmp_path), target)
    for k in ("s", "z", "b", "t", "h"):
        assert out[k] is target[k] and torch.equal(out[k], tree[k]), k
    assert out["n"] == 7 and out["none"] is None
