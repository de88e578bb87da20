"""A reader of `.safetensors` files into torch tensors.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its dtype, shape and [begin, end) byte offsets into
the data buffer that follows (plus an optional `__metadata__` entry), then
the buffer. Tensors are views of one buffer read from the file
(`torch.frombuffer`; numpy has no bfloat16). The port keeps this reader of
its own: the machines it runs on need not have the `safetensors` package.
"""

from __future__ import annotations

import json
import struct

import torch

# the types of diffusers and CLIP checkpoints (I64: CLIP's position_ids)
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}


def load_file(path: str) -> dict:
    """{name: tensor} of a .safetensors file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = end - begin
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=dtype, offset=begin, count=count // dtype.itemsize)
        out[name] = t.reshape(shape)
    return out
