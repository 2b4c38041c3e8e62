"""The safetensors file format, read and written with torch alone.

Replaces the `safetensors` package, which the port does not need.  A file
is an 8-byte little-endian header length N, N bytes of JSON (name ->
{"dtype", "shape", "data_offsets": [begin, end]}, and an optional
"__metadata__" of strings), then the data: every tensor's bytes, C order,
little-endian, at its offsets from the end of the header.

Reading maps each tensor's byte range on its own (`mmap`, copy-on-write)
and builds the tensor straight from those bytes with `torch.frombuffer`
and a reinterpreting view, so bf16 never passes through numpy and nothing
is read before it is used.  The mapping lives as long as the tensor: a
loader that moves one tensor at a time to the card and drops it never holds
more than that tensor's pages in host memory.

Writing streams: the header first (offsets from the shapes and dtypes
alone, padded with spaces to a multiple of 8 as the `safetensors` writer
pads it), then each tensor cast and made contiguous on its own device,
copied to the host and written, one at a time, so a 7B export never holds
the model in host memory.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # the safetensors package's own limit


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"safetensors dtype {name} is not supported (supported: "
                         f"{', '.join(DTYPES)})")
    return DTYPES[name]


class SafeOpen:
    """One .safetensors file: its names, metadata and tensors on the host."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes is too large")
            header = json.loads(f.read(n))
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__", None)
        self._entries = header
        self._base = 8 + n
        self._size = os.path.getsize(path)
        for name, e in header.items():
            begin, end = e["data_offsets"]
            numel = 1
            for s in e["shape"]:
                numel *= s
            want = numel * _dtype(e["dtype"]).itemsize
            if end - begin != want or self._base + end > self._size:
                raise ValueError(f"{path}: tensor {name} has {end - begin} bytes at "
                                 f"[{begin}, {end}), its shape and dtype need {want}")

    def keys(self):
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor on the host, backed by its own mapping of the file
        (or copied out of it when its offset is not a multiple of its item
        size)."""
        e = self._entries[name]
        dtype, shape = _dtype(e["dtype"]), e["shape"]
        begin, end = (self._base + o for o in e["data_offsets"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        start = begin - begin % mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            mm = mmap.mmap(f.fileno(), end - start, access=mmap.ACCESS_COPY, offset=start)
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=begin - start)
        if begin % dtype.itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor on the host} of one file, in the header's order."""
    f = SafeOpen(path)
    return {k: f.get_tensor(k) for k in f.keys()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> int:
    """Write `tensors` (on any device) to `path`, each cast to `dtype` when
    given, as it is written; returns the bytes written.  The data are laid
    out by item size, largest first, then by name, so every tensor starts at
    a multiple of its item size."""
    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    order = sorted(tensors, key=lambda k: (-out_dtype(tensors[k]).itemsize, k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        dt = out_dtype(t)
        if dt not in _NAMES:
            raise ValueError(f"tensor {name}: dtype {dt} has no safetensors name")
        n = t.numel() * dt.itemsize
        header[name] = {"dtype": _NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(dict(sorted(header.items(),
                                  key=lambda kv: (kv[0] != "__metadata__", kv[0]))),
                      separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            # cast and lay out on the tensor's own device, then one copy to the host
            host = t.to(out_dtype(t)).contiguous().reshape(-1).cpu()
            if host.numel():
                f.write(host.view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
