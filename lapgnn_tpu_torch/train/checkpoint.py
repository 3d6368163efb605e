"""Checkpoints: ``meta.json`` + flax-serialised ``params.msgpack``.

Port of ``lapgnn_tpu/train/checkpoint.py`` (``save_checkpoint`` :30,
``load_checkpoint`` :44, ``merge_params`` :66 and ``build_model_from_meta``
:107).  The directory format is unchanged, so
checkpoints stay interchangeable: the JAX package loads what the port
writes and the other way round.

``params.msgpack`` is msgpack as ``flax.serialization`` writes it: nested
maps with string keys, each array an ext value of type 1 whose payload is
itself msgpack, ``[shape, dtype name, raw C-order bytes]``.  The port
carries its own small writer (``msgpack_serialize``, byte-equal to
``flax.serialization.msgpack_serialize`` of the same tree) and reader
(``msgpack_restore``), so that it needs neither the ``msgpack`` package nor
flax.  An array above ``_MAX_CHUNK_BYTES`` (flax's ``MAX_CHUNK_SIZE``, 2**30
bytes) is written, as flax writes it, as a map ``{"__msgpack_chunked_array__":
True, "shape": {"0": ..}, "chunks": {"0": .., "1": ..}}`` of flat chunks of
``MAX_CHUNK_SIZE // itemsize`` elements, and joined back on reading.  The optimizer state is the port's own file, ``opt_state.pt``
(``torch.save``), where the JAX package writes ``opt_state.msgpack``: the
two optimizers' states have different shapes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "build_model_from_meta",
    "load_checkpoint",
    "merge_params",
    "msgpack_restore",
    "msgpack_serialize",
    "save_checkpoint",
]

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: flax splits larger arrays into chunks
_MAX_CHUNK_BYTES = 2**30
_CHUNKED = "__msgpack_chunked_array__"


class _InOrder(dict):
    """A map written in its insertion order, as the ``msgpack`` package
    writes a dict; every other map is written with its keys sorted, the
    order JAX's tree utilities leave them in.  flax builds its chunked
    arrays' maps after that sort, so they keep their own order."""


class _Writer:
    """Encoder for what flax writes: maps with string keys (sorted), arrays
    as ext values, and inside an array's payload a list, ints, a str and
    bin; every value in msgpack's shortest form, as the ``msgpack`` package
    packs it (``use_bin_type=True``)."""

    def __init__(self):
        self.out = bytearray()

    def _size(self, n: int, c8, c16, c32) -> None:
        if c8 is not None and n <= 0xFF:
            self.out += struct.pack(">BB", c8, n)
        elif n <= 0xFFFF:
            self.out += struct.pack(">BH", c16, n)
        else:
            self.out += struct.pack(">BI", c32, n)

    def _int(self, x: int) -> None:
        if 0 <= x <= 0x7F:
            self.out.append(x)
        elif -32 <= x < 0:
            self.out.append(0x100 + x)
        elif x > 0:
            for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                                   (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
                if x <= top:
                    self.out += struct.pack(fmt, code, x)
                    return
            raise OverflowError(f"int {x} too large for msgpack")
        else:
            for code, fmt, bottom in ((0xD0, ">Bb", -(2**7)), (0xD1, ">Bh", -(2**15)),
                                      (0xD2, ">Bi", -(2**31)), (0xD3, ">Bq", -(2**63))):
                if x >= bottom:
                    self.out += struct.pack(fmt, code, x)
                    return
            raise OverflowError(f"int {x} too small for msgpack")

    def _str(self, x: str) -> None:
        b = x.encode("utf-8")
        if len(b) <= 31:
            self.out.append(0xA0 | len(b))
        else:
            self._size(len(b), 0xD9, 0xDA, 0xDB)
        self.out += b

    def _ext(self, code: int, payload: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixed:
            self.out.append(fixed[len(payload)])
        else:
            self._size(len(payload), 0xC7, 0xC8, 0xC9)
        self.out += struct.pack(">b", code) + payload

    def write(self, x: Any) -> None:
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, bool):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.out += struct.pack(">Bd", 0xCB, x)
        elif isinstance(x, str):
            self._str(x)
        elif isinstance(x, (bytes, bytearray)):
            self._size(len(x), 0xC4, 0xC5, 0xC6)
            self.out += x
        elif isinstance(x, (list, tuple)):
            if len(x) <= 15:
                self.out.append(0x90 | len(x))
            else:
                self._size(len(x), None, 0xDC, 0xDD)
            for item in x:
                self.write(item)
        elif isinstance(x, dict):
            if len(x) <= 15:
                self.out.append(0x80 | len(x))
            else:
                self._size(len(x), None, 0xDE, 0xDF)
            if not all(isinstance(k, str) for k in x):
                raise TypeError(f"msgpack_serialize: map keys must be str, got {list(x)}")
            for k in (x if isinstance(x, _InOrder) else sorted(x)):
                self._str(k)
                self.write(x[k])
        elif isinstance(x, np.ndarray):
            self._ext(_EXT_NDARRAY, _ndarray_to_bytes(x))
        elif isinstance(x, np.generic):
            self._ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
        else:
            raise TypeError(f"msgpack_serialize: cannot encode {type(x).__name__}")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    w = _Writer()
    w.write([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(w.out)


def _chunk(arr: np.ndarray) -> _InOrder:
    """flax.serialization._chunk: the flattened array in chunks of
    ``_MAX_CHUNK_BYTES / itemsize`` elements."""
    size = max(1, int(_MAX_CHUNK_BYTES / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return _InOrder({_CHUNKED: True,
                     "shape": _InOrder((str(k), d) for k, d in enumerate(arr.shape)),
                     "chunks": _InOrder((str(k), c) for k, c in enumerate(chunks))})


def _oversized(x: Any) -> bool:
    return isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > _MAX_CHUNK_BYTES


def _chunk_leaves(tree: Any) -> Any:
    """flax.serialization._chunk_array_leaves_in_place on a copy: the
    oversized arrays of the maps (and the tree itself), not those in
    lists."""
    if isinstance(tree, dict):
        return {k: _chunk(v) if _oversized(v) else _chunk_leaves(v) if isinstance(v, dict) else v
                for k, v in tree.items()}
    return _chunk(tree) if _oversized(tree) else tree


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts (str keys) and numpy arrays as
    ``flax.serialization.msgpack_serialize`` encodes it, byte for byte: each
    map's keys sorted, as JAX's tree utilities leave them, and each array
    above ``_MAX_CHUNK_BYTES`` in flax's chunked form."""
    w = _Writer()
    w.write(_chunk_leaves(tree))
    return bytes(w.out)


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
    return _unchunk_leaves(tree)


def _unchunk(data: dict) -> np.ndarray:
    """flax.serialization._unchunk: the chunks joined in order, reshaped."""
    shape = tuple(data["shape"][str(k)] for k in range(len(data["shape"])))
    chunks = [data["chunks"][str(k)] for k in range(len(data["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    """flax.serialization._unchunk_array_leaves_in_place: every chunked
    array among the maps (and the tree itself) joined back."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        return _unchunk(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            tree[k] = _unchunk_leaves(v)
    return tree


def save_checkpoint(path, params, meta: Dict[str, Any], opt_state=None) -> None:
    """Write ``meta.json`` and ``params.msgpack`` (a flax tree of numpy
    arrays, as ``train.convert.params_to_flax`` gives it) into ``path``, and
    ``opt_state.pt`` when an optimizer state (``AdamW.state_dict()``) is
    given."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    (path / "params.msgpack").write_bytes(msgpack_serialize(params))
    if opt_state is not None:
        import torch

        torch.save(opt_state, path / "opt_state.pt")


def load_checkpoint(path, with_opt_state: bool = False) -> Tuple[Any, Dict[str, Any], Optional[Any]]:
    """Returns (params, meta, opt_state): the raw parameter tree, as the JAX
    loader returns without a template, and the port's optimizer state from
    ``opt_state.pt`` when ``with_opt_state`` and the file exists (else
    None)."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    params = msgpack_restore((path / "params.msgpack").read_bytes())
    opt_state = None
    opt_path = path / "opt_state.pt"
    if with_opt_state and opt_path.exists():
        import torch

        opt_state = torch.load(opt_path, weights_only=True)
    return params, meta, opt_state


def merge_params(fresh, loaded):
    """Warm-init merge: onto a freshly initialised tree, every leaf of
    ``loaded`` whose path exists in ``fresh`` with the same shape; the fresh
    value everywhere else (new submodules, changed heads).  Returns
    ``(merged, n_loaded, n_total)``."""
    n_loaded = 0
    n_total = 0

    def walk(f, l):
        nonlocal n_loaded, n_total
        if isinstance(f, dict):
            return {
                k: walk(v, l[k]) if isinstance(l, dict) and k in l else count(v)
                for k, v in f.items()
            }
        n_total += 1
        if hasattr(f, "shape") and hasattr(l, "shape") and tuple(np.shape(f)) == tuple(np.shape(l)):
            n_loaded += 1
            return l
        return f

    def count(v):
        nonlocal n_total
        if isinstance(v, dict):
            return {k: count(x) for k, x in v.items()}
        n_total += 1
        return v

    return walk(fresh, loaded), n_loaded, n_total


def build_model_from_meta(meta: Dict[str, Any]):
    """Rebuild a model from checkpoint metadata (``one_gnn`` or ``dual_gnn``)."""
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
        from ..models import DualGNN

        return DualGNN(
            hidden_dim=int(meta.get("hidden", 128)),
            layers=int(meta.get("layers", 4)),
            heads=int(meta.get("heads", 4)),
            dropout=float(meta.get("dropout", 0.1)),
        )
    raise ValueError(f"unknown architecture in checkpoint meta: {arch}")
