"""Pytree checkpointing, the reference's file format byte for byte:
msgpack + raw ndarray payloads, atomic writes, rotation. Restores onto a
target tree in place (structure and dtypes from the target).

The file is one msgpack map ``{"leaves": [...]}``; each leaf is a map with
the keys ``"dtype"``, ``"shape"`` and ``"data"``, in that order, and the
leaves come in ``jax.tree.flatten`` order (``utils.tree.jax_leaves``):
dicts by sorted key, lists, tuples and NamedTuples in order, ``None``
dropped. A bf16 leaf is written as its exact f32
values under the dtype string ``"bfloat16"``. The dtype strings are the
reference's: the port's int64 counters (AdamW's ``t``) and a Python int
leaf (``HFLState.step``) are int32 there, since jax runs with 64-bit types
off, so they are written as ``"int32"`` and cast back to the target's
dtype on restore.

The msgpack subset the format uses (maps, str, bin, arrays and
non-negative ints) is encoded and decoded here, with the smallest header
for each size, as ``msgpack.packb(..., use_bin_type=True)`` chooses it.
Both directions stream, leaf by leaf and chunk by chunk: the writer copies
a piece of one leaf to the host, writes it and moves on; the reader first
walks every leaf's header against the target, skipping the data, and then
copies each piece of the file into its place in the target. So the host
never holds the whole payload, a file that does not fit the target
changes nothing, and the target's tensors (the flat-backed
``w_ref``/``eps``/``e`` buffers included) are written in place, never
rebound.
"""
from __future__ import annotations

import os
import re
import struct
import tempfile

import numpy as np
import torch

from repro_torch.utils.tree import jax_leaves, jax_map

CHUNK = 1 << 24  # elements per host copy, either direction
_BIN_MAX = (1 << 32) - 1


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------


def _sized(n: int, small, tags, what: str) -> bytes:
    """The header of a sized msgpack object: ``small`` (the fix-form tag
    and its limit) or the first of ``tags`` ((tag, struct format, max))
    that holds ``n``."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    for tag, fmt, top in tags:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack {what} holds at most {tags[-1][2]} "
                     f"{'bytes' if what in ('bin', 'str') else 'entries'}, got {n}")


def uint_header(n: int) -> bytes:
    """A non-negative int: positive fixint, uint8, uint16, uint32, uint64."""
    if isinstance(n, bool) or n < 0:
        raise ValueError(f"the checkpoint format holds non-negative ints only, got {n!r}")
    return _sized(n, (0x00, 0x80), ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                    (0xce, ">I", 0xffffffff),
                                    (0xcf, ">Q", (1 << 64) - 1)), "uint")


def str_header(n: int) -> bytes:
    return _sized(n, (0xa0, 32), ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                  (0xdb, ">I", 0xffffffff)), "str")


def bin_header(n: int) -> bytes:
    """bin8 / bin16 / bin32; a leaf of more than 2**32 - 1 bytes cannot be
    a msgpack bin and raises ``ValueError``."""
    return _sized(n, None, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                            (0xc6, ">I", _BIN_MAX)), "bin")


def array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), ((0xdc, ">H", 0xffff),
                                  (0xdd, ">I", 0xffffffff)), "array")


def map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), ((0xde, ">H", 0xffff),
                                  (0xdf, ">I", 0xffffffff)), "map")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return str_header(len(b)) + b


class _Reader:
    """Reads msgpack objects of the subset from a binary file, in order."""

    def __init__(self, f):
        self.f = f

    def read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("truncated checkpoint")
        return b

    def read_array(self, n: int, dtype) -> np.ndarray:
        """The next ``n`` entries of ``dtype``, as a writable array."""
        buf = bytearray(n * dtype.itemsize)
        if self.f.readinto(buf) != len(buf):
            raise ValueError("truncated checkpoint")
        return np.frombuffer(buf, dtype=dtype)

    def _num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]

    def header(self):
        """-> (kind, value): kind one of "map", "array", "str", "bin" (value:
        the entry count or byte length) or "uint" (value: the int)."""
        t = self.read(1)[0]
        if t < 0x80:
            return "uint", t
        if 0x80 <= t <= 0x8f:
            return "map", t & 0x0f
        if 0x90 <= t <= 0x9f:
            return "array", t & 0x0f
        if 0xa0 <= t <= 0xbf:
            return "str", t & 0x1f
        sized = {0xcc: ("uint", ">B"), 0xcd: ("uint", ">H"), 0xce: ("uint", ">I"),
                 0xcf: ("uint", ">Q"), 0xd9: ("str", ">B"), 0xda: ("str", ">H"),
                 0xdb: ("str", ">I"), 0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"),
                 0xc6: ("bin", ">I"), 0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
                 0xde: ("map", ">H"), 0xdf: ("map", ">I")}
        if t not in sized:
            raise ValueError(f"msgpack type byte 0x{t:02x} is not in the "
                             "checkpoint format")
        kind, fmt = sized[t]
        return kind, self._num(fmt)

    def expect(self, kind: str) -> int:
        got, n = self.header()
        if got != kind:
            raise ValueError(f"checkpoint: expected a msgpack {kind}, got {got}")
        return n

    def obj(self):
        kind, n = self.header()
        if kind == "uint":
            return n
        if kind == "str":
            return self.read(n).decode("utf-8")
        if kind == "bin":
            return self.read(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        return {self.obj(): self.obj() for _ in range(n)}


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, bool):
        return torch.tensor(leaf)
    if isinstance(leaf, int):  # jnp.asarray of a Python int: int32
        return torch.tensor(leaf, dtype=torch.int32)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _file_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype the reference's leaf has: int64 is int32 there."""
    return torch.int32 if t.dtype == torch.int64 else t.dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _record(leaf):
    """-> (tensor, dtype string, shape, data bytes); raises before anything
    is written when the leaf cannot go into the file."""
    t = _as_tensor(leaf)
    dt = _file_dtype(t)
    if dt != t.dtype and t.numel() and t.device.type != "meta":
        lo, hi = int(t.min()), int(t.max())
        if lo < -(1 << 31) or hi >= (1 << 31):
            raise ValueError(f"an int64 leaf holds {lo}..{hi}, outside the "
                             "file's int32")
    width = 4 if dt == torch.bfloat16 else torch.empty((), dtype=dt).element_size()
    nbytes = t.numel() * width
    bin_header(nbytes)  # a msgpack bin holds < 2**32 bytes
    return t, _dtype_name(dt), [int(n) for n in t.shape], nbytes


def _blocks(t: torch.Tensor):
    """Pieces of ``t`` that cover it in C order, contiguous ones at most
    CHUNK elements (views: written in place on restore)."""
    if t.dim() == 0:
        yield t.reshape(1)
    elif t.is_contiguous():
        flat = t.view(-1)
        for a in range(0, flat.numel(), CHUNK):
            yield flat[a:a + CHUNK]
    elif t.dim() == 1:
        yield t
    else:
        for i in range(t.shape[0]):
            yield from _blocks(t[i])


def _host_bytes(block: torch.Tensor, dt: torch.dtype):
    """One piece as the file holds it (bf16 as f32, int64 as int32), as a
    buffer of host memory."""
    want = torch.float32 if dt == torch.bfloat16 else dt
    host = block.to(want).cpu().contiguous()  # the card converts its own
    return host.numpy().data.cast("B")


def write_payload(f, tree) -> int:
    """The reference's ``_encode(tree)`` bytes, streamed into the binary file
    object ``f`` leaf by leaf; -> the number of bytes written."""
    records = [_record(l) for l in jax_leaves(tree)]
    n = 0

    def put(b):
        nonlocal n
        f.write(b)
        n += len(b)

    put(map_header(1) + _str("leaves") + array_header(len(records)))
    for t, dtype, shape, nbytes in records:
        put(map_header(3) + _str("dtype") + _str(dtype) + _str("shape")
            + array_header(len(shape)) + b"".join(uint_header(s) for s in shape)
            + _str("data") + bin_header(nbytes))
        dt = _file_dtype(t)
        for block in _blocks(t):
            put(_host_bytes(block, dt))
    return n


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, step: int, tree, keep: int = 3):
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    fd, tmp = tempfile.mkstemp(dir=path)
    try:  # write_payload checks every leaf before it writes a byte
        with os.fdopen(fd, "wb") as f:
            write_payload(f, tree)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    ckpts = sorted(_list_ckpts(path))
    for s in ckpts[:-keep]:
        os.remove(os.path.join(path, f"ckpt_{s:08d}.msgpack"))
    return final


def _list_ckpts(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for f in os.listdir(path):
        m = re.fullmatch(r"ckpt_(\d+)\.msgpack", f)
        if m:
            out.append(int(m.group(1)))
    return out


def latest_step(path: str):
    ck = _list_ckpts(path)
    return max(ck) if ck else None


def _np_dtype(name: str):
    """The numpy dtype of a leaf's data bytes (bf16 leaves hold f32)."""
    return np.dtype(np.float32) if name == "bfloat16" else np.dtype(name)


def _check_leaf(r: _Reader, tgt, size: int):
    """Reads one leaf record's header and skips its data, checking both
    against the target leaf ``tgt`` and the file's ``size``; -> (the data's
    offset in the file, its numpy dtype, its shape). Nothing is written."""
    rec = {}
    for _ in range(r.expect("map")):
        key = r.obj()
        if key != "data":
            rec[key] = r.obj()
            continue
        if "dtype" not in rec or "shape" not in rec:
            raise ValueError("checkpoint: a leaf's data before its dtype and shape")
        try:
            src = _np_dtype(rec["dtype"])
        except TypeError:
            raise ValueError(f"checkpoint: unknown dtype {rec['dtype']!r}") from None
        shape = tuple(rec["shape"])
        nbytes = r.expect("bin")
        if nbytes != int(np.prod(shape, dtype=np.int64)) * src.itemsize:
            raise ValueError(f"checkpoint: {nbytes} data bytes for a "
                             f"{rec['dtype']} leaf of shape {list(shape)}")
        if isinstance(tgt, torch.Tensor) and tuple(tgt.shape) != shape:
            raise ValueError(f"checkpoint: a leaf of shape {list(shape)} for a "
                             f"target of shape {list(tgt.shape)}")
        if isinstance(tgt, (bool, int, float)) and int(np.prod(shape)) != 1:
            raise ValueError(f"checkpoint: a leaf of shape {list(shape)} for a "
                             f"Python {type(tgt).__name__}")
        offset = r.f.tell()
        if offset + nbytes > size:
            raise ValueError("truncated checkpoint")
        r.f.seek(nbytes, os.SEEK_CUR)
        rec["data"] = (offset, src, shape)
    if "data" not in rec:
        raise ValueError("checkpoint: a leaf without data")
    return rec["data"]


def _load_leaf(r: _Reader, tgt, offset: int, src, shape):
    """The data at ``offset`` copied into the tensor ``tgt`` in place
    (-> tgt), or as a Python scalar or array of the target's kind."""
    r.f.seek(offset)
    if not isinstance(tgt, torch.Tensor):  # a Python scalar (the state's step)
        arr = r.read_array(int(np.prod(shape, dtype=np.int64)), src).reshape(shape)
        if isinstance(tgt, (bool, int, float)):
            return type(tgt)(arr.item())
        return np.asarray(arr, dtype=np.asarray(tgt).dtype)
    for block in _blocks(tgt):
        raw = torch.from_numpy(r.read_array(block.numel(), src))
        block.copy_(raw.to(block.device).to(block.dtype))
    return tgt


def restore_checkpoint(path: str, target, step: int | None = None):
    """Restore the checkpoint at ``step`` (default: the latest) onto
    ``target``: every tensor leaf is overwritten in place with
    ``copy_`` (cast to its dtype), Python scalar leaves are replaced;
    -> (the tree, step). The leaf count must match the target's. The whole
    file is checked against the target (every leaf's dtype, shape and byte
    count, the file's length) before the first leaf is written, so a bad
    file leaves the target as it was."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    leaves = jax_leaves(target)
    with open(os.path.join(path, f"ckpt_{step:08d}.msgpack"), "rb") as f:
        size = os.fstat(f.fileno()).st_size
        r = _Reader(f)
        if r.expect("map") != 1 or r.obj() != "leaves":
            raise ValueError("checkpoint: the payload is not {'leaves': [...]}")
        n = r.expect("array")
        if n != len(leaves):
            raise AssertionError("checkpoint/target mismatch")
        where = [_check_leaf(r, tgt, size) for tgt in leaves]
        if f.tell() != size:
            raise ValueError("checkpoint: extra data after the payload")
        new = [_load_leaf(r, tgt, *w) for tgt, w in zip(leaves, where)]
    it = iter(new)
    return jax_map(lambda _: next(it), target), step
