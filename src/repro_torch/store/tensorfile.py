"""Safetensors-style single-file tensor serialization (the disk tier), the
counterpart of ``repro.store.tensorfile`` over CPU ``torch.Tensor``s.

Layout (the safetensors container, so files are inspectable with standard
tooling; the same bytes as the reference's file for the same tensors):

    [8 bytes]  little-endian uint64 N = header length
    [N bytes]  JSON header: {name: {"dtype", "shape", "data_offsets"}}
    [...]      raw tensor bytes, C-contiguous, concatenated in offset order

``dtype`` strings follow the safetensors convention ("F32", "BF16", ...).
Tensors are written and read through numpy; numpy has no bfloat16 without
``ml_dtypes``, so BF16 goes through a 16-bit integer view of the same
bits. Round-trips are bitwise exact, which lets the adapter store's disk
tier take part in the token bit-identity invariant.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

# safetensors dtype tag <-> torch dtype (the subset adapters use)
_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TAGS = {v: k for k, v in _DTYPES.items()}


def dtype_tag(dt: torch.dtype) -> str:
    """Safetensors tag for a torch dtype (raises on unsupported)."""
    if dt not in _TAGS:
        raise ValueError(f"unsupported tensor dtype {dt}")
    return _TAGS[dt]


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save(path: str, tensors: Dict[str, torch.Tensor]) -> int:
    """Write ``tensors`` to ``path``; returns the payload byte count."""
    header: Dict[str, Dict] = {}
    blobs = []
    off = 0
    for name in sorted(tensors):
        t = tensors[name]
        raw = _raw(t)
        header[name] = {"dtype": dtype_tag(t.dtype),
                        "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for raw in blobs:
            f.write(raw)
    return off


def load(path: str) -> Dict[str, torch.Tensor]:
    """Read a file written by ``save``; bitwise-exact CPU tensors by name."""
    with open(path, "rb") as f:
        raw_len = f.read(8)
        if len(raw_len) != 8:
            raise ValueError(f"{path}: truncated header length")
        (hlen,) = struct.unpack("<Q", raw_len)
        raw_hdr = f.read(hlen)
        if len(raw_hdr) != hlen:
            raise ValueError(f"{path}: truncated header")
        try:
            header = json.loads(raw_hdr.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt header: {e}") from e
        payload = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        dt = _DTYPES.get(meta["dtype"])
        if dt is None:
            raise ValueError(f"{path}: unknown dtype tag {meta['dtype']!r}")
        s, e = meta["data_offsets"]
        view = torch.int16 if dt == torch.bfloat16 else dt
        np_dt = torch.empty(0, dtype=view).numpy().dtype
        arr = np.frombuffer(payload[s:e], dtype=np_dt)
        t = torch.from_numpy(arr.reshape(meta["shape"]).copy())
        out[name] = t.view(dt) if dt == torch.bfloat16 else t
    return out
