"""Reader and writer of the msgpack files ``flax.serialization`` writes.

A checkpoint's ``params.msgpack`` is ``flax.serialization.to_bytes`` of the
parameter tree, which this module reads and writes without ``flax`` or
``msgpack``.  It covers the subset those files use:

  * maps, arrays, strings, bin, ints, floats, nil and bool;
  * ext type 1, an ndarray packed as the msgpack array
    ``(shape, dtype name, C-order buffer)``;
  * ext type 3, a numpy scalar packed the same way;
  * flax's chunked form of a leaf over ``MAX_CHUNK_SIZE`` bytes: a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat0, ...}}``.

Arrays read back as numpy arrays, except ``bfloat16`` ones, which numpy has
no dtype for: they read back as ``torch.bfloat16`` tensors.  The writer
takes numpy arrays and torch tensors (a bf16 tensor is written as
``bfloat16``), lists and tuples as msgpack arrays, and dict keys as strings.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax splits a leaf above this many bytes (msgpack's limit is 2^31 - 1 per
# object)
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------
def _pack_uint_header(out: io.BytesIO, n: int, fix_base: int, fix_max: int, codes: tuple) -> None:
    """A length header: fix form below ``fix_max``, else the 8/16/32-bit code
    (``codes[i]`` is None where the type has no such width)."""
    if fix_base is not None and n < fix_max:
        out.write(bytes([fix_base | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.write(bytes([codes[0], n]))
    elif n < 1 << 16:
        out.write(bytes([codes[1]]) + struct.pack(">H", n))
    else:
        out.write(bytes([codes[2]]) + struct.pack(">I", n))


def _pack_int(out: io.BytesIO, v: int) -> None:
    if 0 <= v < 128:
        out.write(bytes([v]))
    elif -32 <= v < 0:
        out.write(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out.write(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                               (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out.write(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_bin(out: io.BytesIO, data: bytes) -> None:
    _pack_uint_header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out.write(data)


def _pack_ext(out: io.BytesIO, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.write(bytes([fixed[n], code]))
    elif n < 1 << 8:
        out.write(bytes([0xC7, n, code]))
    elif n < 1 << 16:
        out.write(bytes([0xC8]) + struct.pack(">H", n) + bytes([code]))
    else:
        out.write(bytes([0xC9]) + struct.pack(">I", n) + bytes([code]))
    out.write(data)


def _array_payload(x) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    x = np.asarray(x)  # 0-d stays 0-d (np.ascontiguousarray would make it 1-d)
    if x.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _pack_ndarray_ext(out: io.BytesIO, code: int, x) -> None:
    inner = io.BytesIO()
    _pack(inner, _array_payload(x))
    _pack_ext(out, code, inner.getvalue())


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunked(x) -> dict:
    """flax's chunked map of an oversized leaf (flat slices of the array)."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = [flat[i : i + size] for i in range(0, flat.shape[0], size)]
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _pack(out: io.BytesIO, obj) -> None:
    if obj is None:
        out.write(b"\xc0")
    elif obj is True:
        out.write(b"\xc3")
    elif obj is False:
        out.write(b"\xc2")
    elif isinstance(obj, (np.ndarray, torch.Tensor)) and not (isinstance(obj, torch.Tensor) and obj.dim() == 0):
        _pack_ndarray_ext(out, EXT_NDARRAY, obj)
    elif isinstance(obj, (np.generic, torch.Tensor)):
        _pack_ndarray_ext(out, EXT_NPSCALAR, obj if isinstance(obj, torch.Tensor) else np.asarray(obj))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_uint_header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(out, bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_uint_header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_uint_header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            if isinstance(value, (np.ndarray, torch.Tensor)) and _nbytes(value) > MAX_CHUNK_SIZE:
                value = _chunked(value)
            _pack(out, value)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(tree) -> bytes:
    """Serialize a tree as ``flax.serialization.msgpack_serialize`` does."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    out = io.BytesIO()
    _pack(out, tree)
    return out.getvalue()


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2), 0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8), 0xD8: lambda: self.ext(16),
            0xD9: lambda: self.string(self.unpack(">B")),
            0xDA: lambda: self.string(self.unpack(">H")),
            0xDB: lambda: self.string(self.unpack(">I")),
            0xDC: lambda: [self.value() for _ in range(self.unpack(">H"))],
            0xDD: lambda: [self.value() for _ in range(self.unpack(">I"))],
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _array_from_payload(data: bytes):
    shape, name, buffer = _Reader(data, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.int16) if buffer else torch.zeros(0, dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(tuple(shape), order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """Deserialize what ``flax.serialization.msgpack_serialize`` wrote,
    chunked leaves joined back into arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
