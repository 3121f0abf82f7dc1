"""Byte-accurate codecs for the flat-buffer sparse sync payloads: the port
of ``repro.comm.codecs``.

A *payload* is what ``core.sparsify.pack_phi`` produces for one hop of the
every-H consensus: ``(values [k] f32, indices [k] int32)`` over a flat
vector of ``size`` entries. Each codec defines an exact wire format and
mutually consistent views of it:

  * ``encode``              -> the byte stream (numpy ``uint8``)
  * ``decode``              -> the payload the receiver reconstructs
  * ``measure_bits``        -> closed-form stream length (Python int);
                               ALWAYS ``8 * len(encode(...))``
  * ``measure_bits_torch``  -> the same count as a 0-d int64 tensor on the
                               payload's device, computed there without a
                               host sync (the twin of the reference's
                               ``measure_bits_jax``)

The registry, names, aliases and wire formats are the reference's:
``dense-f32``, ``dense-bf16``, ``bitmap`` (alias ``bitmap+values``),
``bitmap-q8``, ``delta-varint``, ``delta-varint-q8``, ``delta-gamma``
(alias ``delta-elias-gamma``), ``delta-gamma-q8`` and the ``best``
meta-codec. Codecs canonicalize payloads by sorting on index; the bitmap
codec also coalesces duplicate indices by summation.

Inputs are numpy arrays or tensors; a tensor on the card is copied to the
host explicitly (``.cpu()``) before the host paths read it.

bf16 without a bf16 numpy package: the value stream is the 16-bit pattern
of ``torch``'s round-to-nearest-even float32 -> bfloat16 cast, written as
little-endian bytes; on finite values, +-0, +-inf and subnormals these are
the reference's bytes. A NaN goes on the wire as the quiet NaN of its sign
(0x7FC0 or 0xFFC0) whatever its payload, as the reference's cast does;
torch's own cast gives 0x7FC0 on one code path and 0xFFFF on its
vectorized one, so the codec writes NaNs itself.

Device counts are int64, so unlike the reference's int32 traced counts
(which wrap above ~50M transmitted entries) they equal the host
``measure_bits`` at any payload size.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve

# ---------------------------------------------------------------------------
# Bit-stream helpers (MSB-first, used by the Elias-gamma index stream)
# ---------------------------------------------------------------------------


class BitWriter:
    """MSB-first bit packer; ``flush`` zero-pads to a byte boundary."""

    def __init__(self):
        self._out = bytearray()
        self._cur = 0
        self._n = 0

    def write(self, value: int, nbits: int) -> None:
        for b in range(nbits - 1, -1, -1):
            self._cur = (self._cur << 1) | ((value >> b) & 1)
            self._n += 1
            if self._n == 8:
                self._out.append(self._cur)
                self._cur = 0
                self._n = 0

    def flush(self) -> bytes:
        if self._n:
            self._out.append(self._cur << (8 - self._n))
            self._cur = 0
            self._n = 0
        return bytes(self._out)


class BitReader:
    def __init__(self, buf):
        self._buf = buf
        self._pos = 0  # bit cursor

    def read(self, nbits: int) -> int:
        out = 0
        for _ in range(nbits):
            byte = self._buf[self._pos >> 3]
            out = (out << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return out

    def read_unary_zeros(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n


def elias_gamma_bits(n) -> int:
    """Bit length of the Elias-gamma code of ``n >= 1``: 2·⌊log2 n⌋ + 1."""
    return 2 * (int(n).bit_length() - 1) + 1


def varint_len(d) -> int:
    """LEB128 byte length of ``d >= 0``."""
    d = int(d)
    return max(1, -(-d.bit_length() // 7))


# ---------------------------------------------------------------------------
# Host and device views of the inputs
# ---------------------------------------------------------------------------


def _host(a, dtype) -> np.ndarray:
    """numpy copy of an array or tensor (a tensor on the card comes over
    with an explicit ``.cpu()``), flattened."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a).reshape(-1).astype(dtype)


def _tensor(a) -> torch.Tensor:
    """A tensor stays where it lies; a numpy array becomes a CPU tensor."""
    return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """0-d int64 constant on ``like``'s device, made there (no copy, so
    no host sync)."""
    return torch.full((), value, dtype=torch.int64, device=like.device)


# ---------------------------------------------------------------------------
# Value formats: how the k transmitted values ride the wire
# ---------------------------------------------------------------------------


class _F32Values:
    """Raw little-endian float32; lossless."""

    bits, header_bits, tag = 32, 0, "f32"

    def encode(self, v: np.ndarray) -> bytes:
        return v.astype("<f4").tobytes()

    def parse(self, buf: bytes, off: int, k: int) -> Tuple[np.ndarray, int]:
        v = np.frombuffer(buf, dtype="<f4", count=k, offset=off)
        return v.astype(np.float32), off + 4 * k

    def wire(self, v: np.ndarray) -> np.ndarray:
        return v.astype(np.float32)


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 patterns of f32 ``v``: torch's round-to-nearest-even
    cast, a NaN replaced by the quiet NaN of its sign (module docstring)."""
    v = np.ascontiguousarray(v, np.float32)
    bits = torch.from_numpy(v.copy()).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().view(np.uint16).copy()
    nan = np.isnan(v)
    bits[nan] = np.where(np.signbit(v[nan]), 0xFFC0, 0x7FC0)
    return bits


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """float32 values of uint16 bfloat16 patterns (exact)."""
    t = torch.from_numpy(np.ascontiguousarray(bits, np.uint16).view(np.int16).copy())
    return t.view(torch.bfloat16).float().numpy()


class _BF16Values:
    """bfloat16 round-to-nearest-even: the wire format of the engine's
    ``quantized_sparse`` mode (``core.hfl._wire_round_rows``)."""

    bits, header_bits, tag = 16, 0, "bf16"

    def encode(self, v: np.ndarray) -> bytes:
        return _bf16_bits(v).astype("<u2").tobytes()

    def parse(self, buf: bytes, off: int, k: int) -> Tuple[np.ndarray, int]:
        u = np.frombuffer(buf, dtype="<u2", count=k, offset=off)
        return _bf16_to_f32(u), off + 2 * k

    def wire(self, v: np.ndarray) -> np.ndarray:
        return _bf16_to_f32(_bf16_bits(v))


class _Q8Values:
    """8-bit linear quantization: codes = clip(rint(v/scale), ±127) with
    scale = max|v|/127 carried as an f32 header. All arithmetic is f32 so
    the host round-trip is bit-identical to the sync's
    ``core.hfl._wire_round_rows(x, "q8")``."""

    bits, header_bits, tag = 8, 32, "q8"

    @staticmethod
    def scale_of(v: np.ndarray) -> np.float32:
        amax = np.float32(np.max(np.abs(v))) if v.size else np.float32(0.0)
        return amax / np.float32(127.0) if amax > 0 else np.float32(1.0)

    def encode(self, v: np.ndarray) -> bytes:
        v = v.astype(np.float32)
        scale = self.scale_of(v)
        codes = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
        return struct.pack("<f", scale) + codes.tobytes()

    def parse(self, buf: bytes, off: int, k: int) -> Tuple[np.ndarray, int]:
        (scale,) = struct.unpack_from("<f", buf, off)
        codes = np.frombuffer(buf, dtype=np.int8, count=k, offset=off + 4)
        return codes.astype(np.float32) * np.float32(scale), off + 4 + k

    def wire(self, v: np.ndarray) -> np.ndarray:
        v = v.astype(np.float32)
        scale = self.scale_of(v)
        codes = np.clip(np.rint(v / scale), -127, 127).astype(np.float32)
        return codes * scale


_VALUE_FORMATS = {"f32": _F32Values(), "bf16": _BF16Values(), "q8": _Q8Values()}


# ---------------------------------------------------------------------------
# Codec base
# ---------------------------------------------------------------------------


def _canonical(values, indices) -> Tuple[np.ndarray, np.ndarray]:
    """Sort a payload by index (stable; scatter-add is order-invariant)."""
    v = _host(values, np.float32)
    i = _host(indices, np.int64)
    order = np.argsort(i, kind="stable")
    return v[order], i[order]


def _sorted_indices(indices) -> torch.Tensor:
    """int64 indices sorted on their own device."""
    return torch.sort(_tensor(indices).reshape(-1).long()).values


class Codec:
    """Interface; see the module docstring for the invariants."""

    name: str = ""
    aliases: Tuple[str, ...] = ()

    @property
    def value_format(self) -> str:
        """Fidelity of the value stream: f32 | bf16 | q8 | mixed (best)."""
        fmt = getattr(self, "_fmt", None)
        return fmt.tag if fmt is not None else "mixed"

    def encode(self, values, indices, size: int) -> np.ndarray:
        raise NotImplementedError

    def decode(self, blob, size: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def measure_bits(self, values, indices, size: int) -> int:
        raise NotImplementedError

    def measure_bits_torch(self, values, indices, size: int) -> torch.Tensor:
        raise NotImplementedError

    def wire_values(self, values) -> np.ndarray:
        """Receiver-visible values (identity for f32, rounded for bf16/q8)."""
        raise NotImplementedError

    def decode_dense(self, blob, size: int) -> np.ndarray:
        """Scatter-add view of ``decode`` (the consensus-side reconstruction)."""
        v, i = self.decode(blob, size)
        out = np.zeros(size, np.float32)
        np.add.at(out, i, v)
        return out


class DenseCodec(Codec):
    """The whole dense vector on the wire; the φ=0 reference formats."""

    def __init__(self, name: str, fmt: str):
        self.name = name
        self._fmt = _VALUE_FORMATS[fmt]

    def _densify(self, values, indices, size: int) -> np.ndarray:
        v, i = _canonical(values, indices)
        out = np.zeros(size, np.float32)
        np.add.at(out, i, v)
        return out

    def encode(self, values, indices, size: int) -> np.ndarray:
        dense = self._densify(values, indices, size)
        return np.frombuffer(self._fmt.encode(dense), np.uint8)

    def decode(self, blob, size: int):
        buf = np.asarray(blob, np.uint8).tobytes()
        v, _ = self._fmt.parse(buf, 0, size)
        return v, np.arange(size, dtype=np.int32)

    def measure_bits(self, values, indices, size: int) -> int:
        return self._fmt.bits * size

    def measure_bits_torch(self, values, indices, size: int):
        return _const(self._fmt.bits * size, _tensor(values))

    def wire_values(self, values):
        return self._fmt.wire(_host(values, np.float32))


class BitmapCodec(Codec):
    """``ceil(size/8)`` bitmap bytes (LSB-first) + set-bit values in index
    order. Duplicate indices are coalesced by summation. ``impl="pallas"``
    packs the presence mask with the ``bitpack`` kernel
    (``kernels/bitpack``) on ``device`` (the card unless the caller names
    the CPU); both impls emit identical bytes."""

    def __init__(self, name: str, fmt: str, aliases: Tuple[str, ...] = ()):
        self.name = name
        self.aliases = aliases
        self._fmt = _VALUE_FORMATS[fmt]

    def _coalesce(self, values, indices):
        v, i = _canonical(values, indices)
        if v.size == 0:
            return v, i
        firsts = np.ones(i.size, bool)
        firsts[1:] = i[1:] != i[:-1]
        starts = np.nonzero(firsts)[0]
        return np.add.reduceat(v, starts).astype(np.float32), i[starts]

    def encode(self, values, indices, size: int, *, impl: str = "np",
               device=None) -> np.ndarray:
        v, i = self._coalesce(values, indices)
        if impl == "np":
            bits = np.zeros(size, np.uint8)
            bits[i] = 1
            packed = np.packbits(bits, bitorder="little").tobytes()
        elif impl == "pallas":
            from repro_torch.kernels.bitpack import ops as _bp

            dev = resolve(device)
            mask = torch.zeros((size,), dtype=torch.float32, device=dev)
            mask[torch.from_numpy(i).to(dev)] = 1.0
            packed = _bp.bitpack_bytes(mask)
        else:
            raise ValueError(impl)
        return np.frombuffer(packed + self._fmt.encode(v), np.uint8)

    def decode(self, blob, size: int):
        buf = np.asarray(blob, np.uint8).tobytes()
        nb = (size + 7) // 8
        bits = np.unpackbits(
            np.frombuffer(buf, np.uint8, count=nb), bitorder="little"
        )[:size]
        idx = np.nonzero(bits)[0].astype(np.int32)
        v, _ = self._fmt.parse(buf, nb, len(idx))
        return v, idx

    def measure_bits(self, values, indices, size: int) -> int:
        k_uniq = int(np.unique(_host(indices, np.int64)).size)
        return 8 * ((size + 7) // 8) + self._fmt.header_bits + self._fmt.bits * k_uniq

    def measure_bits_torch(self, values, indices, size: int):
        idx = _sorted_indices(indices)
        static = 8 * ((size + 7) // 8) + self._fmt.header_bits
        if idx.numel() == 0:
            return _const(static, idx)
        k_uniq = 1 + (idx[1:] != idx[:-1]).sum()
        return k_uniq * self._fmt.bits + static

    def wire_values(self, values):
        return self._fmt.wire(_host(values, np.float32))


class DeltaCodec(Codec):
    """``[uint32 k][value header][index-gap stream][values]``. Gaps are
    deltas of the sorted indices (first gap = the first index); ``varint``
    emits them as LEB128 bytes, ``gamma`` as MSB-first Elias-gamma codes of
    ``gap+1`` (gamma cannot code 0) padded to a byte boundary."""

    def __init__(self, name: str, scheme: str, fmt: str,
                 aliases: Tuple[str, ...] = ()):
        assert scheme in ("varint", "gamma")
        self.name = name
        self.aliases = aliases
        self._scheme = scheme
        self._fmt = _VALUE_FORMATS[fmt]

    @staticmethod
    def _gaps(i: np.ndarray) -> np.ndarray:
        d = np.empty(i.size, np.int64)
        if i.size:
            d[0] = i[0]
            d[1:] = i[1:] - i[:-1]
        return d

    def encode(self, values, indices, size: int) -> np.ndarray:
        v, i = _canonical(values, indices)
        out = bytearray(struct.pack("<I", v.size))
        if self._scheme == "varint":
            for d in self._gaps(i):
                d = int(d)
                while True:
                    byte = d & 0x7F
                    d >>= 7
                    out.append(byte | (0x80 if d else 0))
                    if not d:
                        break
        else:
            bw = BitWriter()
            for d in self._gaps(i):
                n = int(d) + 1
                zlen = n.bit_length() - 1
                bw.write(0, zlen)
                bw.write(n, zlen + 1)
            out += bw.flush()
        out += self._fmt.encode(v)
        return np.frombuffer(bytes(out), np.uint8)

    def decode(self, blob, size: int):
        buf = np.asarray(blob, np.uint8).tobytes()
        (k,) = struct.unpack_from("<I", buf, 0)
        off = 4
        gaps = np.empty(k, np.int64)
        if self._scheme == "varint":
            for j in range(k):
                d, shift = 0, 0
                while True:
                    byte = buf[off]
                    off += 1
                    d |= (byte & 0x7F) << shift
                    shift += 7
                    if not byte & 0x80:
                        break
                gaps[j] = d
        else:
            br = BitReader(buf[off:])
            nbits = 0
            for j in range(k):
                z = br.read_unary_zeros()
                n = (1 << z) | br.read(z) if z else 1
                gaps[j] = n - 1
                nbits += 2 * z + 1
            off += (nbits + 7) // 8
        idx = np.cumsum(gaps).astype(np.int32) if k else np.zeros(0, np.int32)
        v, _ = self._fmt.parse(buf, off, k)
        return v, idx

    def measure_bits(self, values, indices, size: int) -> int:
        _, i = _canonical(values, indices)
        d = self._gaps(i)
        if self._scheme == "varint":
            idx_bits = 8 * sum(varint_len(g) for g in d)
        else:
            gb = sum(elias_gamma_bits(int(g) + 1) for g in d)
            idx_bits = 8 * ((gb + 7) // 8)
        return 32 + self._fmt.header_bits + idx_bits + self._fmt.bits * i.size

    def measure_bits_torch(self, values, indices, size: int):
        idx = _sorted_indices(indices)
        k = idx.numel()
        static = 32 + self._fmt.header_bits + self._fmt.bits * k
        if k == 0:
            return _const(static, idx)
        d = torch.cat([idx[:1], idx[1:] - idx[:-1]])
        if self._scheme == "varint":
            nb = torch.ones_like(d)
            for j in range(7, 63, 7):  # LEB128 bytes of an int64 gap
                nb += d >= (1 << j)
            idx_bits = 8 * nb.sum()
        else:
            m = d + 1
            fl = torch.zeros_like(m)
            for j in range(1, 63):  # ⌊log2 m⌋ of an int64 m >= 1
                fl += m >= (1 << j)
            gb = (2 * fl + 1).sum()
            idx_bits = 8 * ((gb + 7) // 8)
        return idx_bits + static

    def wire_values(self, values):
        return self._fmt.wire(_host(values, np.float32))


class BestCodec(Codec):
    """Meta-codec: the cheapest concrete codec per payload, selected by the
    closed-form ``measure_bits`` with a 1-byte codec-id header. First in
    order wins ties, so the choice is deterministic."""

    name = "best"

    def __init__(self, candidates):
        self._cands = tuple(candidates)

    def choose(self, values, indices, size: int):
        """-> (winning codec, its stream bits, without the id header)."""
        bits = [c.measure_bits(values, indices, size) for c in self._cands]
        j = int(np.argmin(bits))
        return self._cands[j], bits[j]

    def encode(self, values, indices, size: int) -> np.ndarray:
        codec, _ = self.choose(values, indices, size)
        cid = self._cands.index(codec)
        sub = codec.encode(values, indices, size)
        return np.concatenate([np.array([cid], np.uint8), sub])

    def decode(self, blob, size: int):
        blob = np.asarray(blob, np.uint8)
        return self._cands[int(blob[0])].decode(blob[1:], size)

    def measure_bits(self, values, indices, size: int) -> int:
        return 8 + self.choose(values, indices, size)[1]

    def measure_bits_torch(self, values, indices, size: int):
        return 8 + torch.stack(
            [c.measure_bits_torch(values, indices, size) for c in self._cands]
        ).min()

    def wire_values(self, values):
        # the winner's rounding is what the receiver sees; report the f32
        # identity (use the concrete codec for exact wire semantics)
        return _host(values, np.float32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

CODECS: Dict[str, Codec] = {}
_ALIASES: Dict[str, str] = {}


def _register(codec: Codec) -> Codec:
    CODECS[codec.name] = codec
    for a in codec.aliases:
        _ALIASES[a] = codec.name
    return codec


_register(DenseCodec("dense-f32", "f32"))
_register(DenseCodec("dense-bf16", "bf16"))
_register(BitmapCodec("bitmap", "f32", aliases=("bitmap+values",)))
_register(BitmapCodec("bitmap-q8", "q8"))
_register(DeltaCodec("delta-varint", "varint", "f32"))
_register(DeltaCodec("delta-varint-q8", "varint", "q8"))
_register(DeltaCodec("delta-gamma", "gamma", "f32",
                     aliases=("delta-elias-gamma",)))
_register(DeltaCodec("delta-gamma-q8", "gamma", "q8"))
_register(BestCodec([CODECS[n] for n in (
    "dense-f32", "dense-bf16", "bitmap", "bitmap-q8",
    "delta-varint", "delta-varint-q8", "delta-gamma", "delta-gamma-q8",
)]))


def get_codec(name: str) -> Codec:
    key = _ALIASES.get(name, name)
    if key not in CODECS:
        raise KeyError(
            f"unknown codec {name!r}; choose from {sorted(list_codecs())}"
        )
    return CODECS[key]


def list_codecs():
    return tuple(CODECS) + tuple(_ALIASES)
