"""The safetensors file format, read and written with torch alone.

The port's counterpart of the two `safetensors` calls the reference makes
(`safetensors.numpy.load_file` in `models/convert_hf.py`, `save_file` in
`utils/checkpoint.py`), without the package: a file is an 8-byte
little-endian header length N, N bytes of JSON header ({name: {"dtype",
"shape", "data_offsets": [begin, end]}, optional "__metadata__": {str:
str}}), then the tensors' raw little-endian bytes, offsets counted from
the end of the header. Unlike numpy, torch has bfloat16, so BF16 files
(the published checkpoints' dtype) load as they are stored.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
CODES = {v: k for k, v in DTYPES.items()}
# headers larger than this are refused, as the safetensors package does
MAX_HEADER_BYTES = 100 * 1024 * 1024


def read_header(path: str) -> tuple:
    """(header dict, offset of the first data byte) of a safetensors
    file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, each tensor a view of the
    memory-mapped file in its stored dtype (copy-on-write: writing to one
    never touches the file). Pages are read from disk when first touched."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    data = torch.from_file(path, shared=False, size=size, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, not one of "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * itemsize or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}) for shape {shape} "
                             f"{info['dtype']}")
        raw = data[start + begin:start + end]
        if (start + begin) % itemsize:
            raw = raw.clone()          # a view must start on an element
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device; written from host copies) as one
    safetensors file: the header padded with spaces to a multiple of 8
    bytes, the tensors' bytes in name order."""
    header, offset, names = {}, 0, sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors code")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
