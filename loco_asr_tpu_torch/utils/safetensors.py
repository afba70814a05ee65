"""A ``.safetensors`` reader without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus an
optional ``__metadata__``), then the raw little-endian buffers, each at its
offsets from the end of the header.  Reads F32, F16, BF16 and I64 tensors
into CPU tensors, as ``safetensors.torch.load_file`` does.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, by name, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; this reader "
                             f"takes {', '.join(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end > begin:
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out
