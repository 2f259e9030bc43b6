"""HuggingFace checkpoint directories read (and safetensors files written)
without ``transformers``, ``safetensors`` or any hub access.

A directory holds ``config.json`` and its weights as one of:

  * ``model.safetensors``: an 8-byte little-endian header length, a JSON
    header mapping each tensor's name to its ``dtype``, ``shape`` and
    ``data_offsets`` (begin, end) into the data that follows, raw
    little-endian bytes (the format's documented layout);
  * ``pytorch_model.bin``: a ``torch.save`` state dict, read with
    ``weights_only=True``;
  * either one sharded: ``model.safetensors.index.json`` or
    ``pytorch_model.bin.index.json`` maps each name to its shard file.

``load_state_dict`` returns the tensors under the checkpoint's own names;
the loaders of the models map those names (``models/encoder.py``,
``models/t5.py``, ``models/xmod.py``).
"""

from __future__ import annotations

import json
import os
import struct

import torch

CONFIG_NAME = "config.json"
SAFETENSORS_NAME = "model.safetensors"
BIN_NAME = "pytorch_model.bin"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_config(path: str) -> dict:
    """The checkpoint's ``config.json``."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        return json.load(f)


def read_safetensors(file: str) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        dtype = _DTYPES[entry["dtype"]]
        if end == begin:
            flat = torch.empty(0, dtype=dtype)
        elif begin % dtype.itemsize:  # a misaligned tensor gets its own aligned copy
            flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            flat = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize, offset=begin)
        out[name] = flat.reshape(entry["shape"])
    return out


def write_safetensors(tensors: dict[str, torch.Tensor], file: str) -> None:
    """Write ``tensors`` (any device) as one ``.safetensors`` file."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)  # the data starts 8-byte aligned
    with open(file, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def _read_file(file: str) -> dict[str, torch.Tensor]:
    if file.endswith(".safetensors"):
        return read_safetensors(file)
    return torch.load(file, map_location="cpu", weights_only=True)


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The checkpoint directory's tensors under their own names, from its
    safetensors or ``.bin`` weights, single or sharded (safetensors first,
    as ``transformers`` prefers them)."""
    for name in (SAFETENSORS_NAME, BIN_NAME):
        single = os.path.join(path, name)
        if os.path.isfile(single):
            return _read_file(single)
        index = single + ".index.json"
        if os.path.isfile(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            out: dict[str, torch.Tensor] = {}
            for shard in shards:
                out.update(_read_file(os.path.join(path, shard)))
            return out
    raise FileNotFoundError(f"{path} holds no {SAFETENSORS_NAME} or {BIN_NAME} (single or sharded)")
