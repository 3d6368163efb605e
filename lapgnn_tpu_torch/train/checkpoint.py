"""Checkpoint loading: ``meta.json`` + flax-serialised ``params.msgpack``.

Port of ``lapgnn_tpu/train/checkpoint.py`` (``load_checkpoint`` :44 and the
``one_gnn`` branch of ``build_model_from_meta`` :107).  The directory format
is unchanged, so checkpoints stay interchangeable.

``params.msgpack`` is msgpack as ``flax.serialization`` writes it: nested
maps with string keys, each array an ext value of type 1 whose payload is
itself msgpack, ``[shape, dtype name, raw C-order bytes]``.  The port
carries its own small reader (``msgpack_restore``) so that it needs neither
the ``msgpack`` package nor flax.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["msgpack_restore", "load_checkpoint", "build_model_from_meta"]

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax writes: nil, bool, ints, floats,
    str, bin, array, map and ext."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, k: int) -> memoryview:
        if self.pos + k > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + k]
        self.pos += k
        return out

    def _unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, k: int):
        b = bytes(self._take(k))
        return b if self.raw else b.decode("utf-8")

    def _array(self, k: int) -> list:
        return [self.read() for _ in range(k)]

    def _map(self, k: int) -> dict:
        out = {}
        for _ in range(k):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, k: int) -> Any:
        code = self._unpack(">b")
        return _decode_ext(code, bytes(self._take(k)))

    def read(self) -> Any:
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])))
        if t in (0xC7, 0xC8, 0xC9):
            return self._ext(self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t]))
        if t == 0xCA:
            return self._unpack(">f")
        if t == 0xCB:
            return self._unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self._unpack(
                {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[t]
            )
        if 0xD4 <= t <= 0xD8:
            return self._ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload, raw=True).read()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes, which the port does not use")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape, order="C")


def _decode_ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).read()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-serialised bytes into a tree of dicts and numpy arrays,
    equal to ``flax.serialization.msgpack_restore`` of the same bytes."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    if _has_chunked(tree):
        raise NotImplementedError("chunked (> 2 GiB) arrays are not supported")
    return tree


def _has_chunked(tree: Any) -> bool:
    if isinstance(tree, dict):
        return "__msgpack_chunked_array__" in tree or any(
            _has_chunked(v) for v in tree.values()
        )
    return False


def load_checkpoint(path) -> Tuple[Any, Dict[str, Any], Optional[Any]]:
    """Returns (params, meta, None): the raw parameter tree, as the JAX
    loader returns without a template.  Optimizer state is not loaded."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    params = msgpack_restore((path / "params.msgpack").read_bytes())
    return params, meta, None


def build_model_from_meta(meta: Dict[str, Any]):
    """Rebuild a model from checkpoint metadata (``one_gnn`` only so far)."""
    arch = meta.get("architecture", "one_gnn")
    if arch == "one_gnn":
        from ..models import OneGNN

        return OneGNN(
            in_dim=int(meta.get("row_feat_dim", 21)),
            hidden=int(meta.get("hidden", 64)),
            layers=int(meta.get("layers", 2)),
            dropout=float(meta.get("dropout", 0.1)),
            topk=int(meta.get("topk", 16)),
            context=bool(meta.get("context", False)),
        )
    if arch == "dual_gnn":
        raise NotImplementedError("DualGNN is not ported yet (see ROADMAP.md)")
    raise ValueError(f"unknown architecture in checkpoint meta: {arch}")
