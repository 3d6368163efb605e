"""HDF5 dataset IO in the JAX package's ragged schema.

Port of ``lapgnn_tpu/data/h5io.py``; the schema is unchanged, so either
package reads the other's files: ragged variable-length datasets ``C`` (the
cost matrix flattened row-major), ``u``, ``v``, ``rows``, ``cols``, and scalar
columns ``cost``, ``n``, ``family``, ``noise_std``, ``tag``.  ``h5py`` is
imported only when a file is opened, so the port imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, List, Sequence, Union

import numpy as np

from .synthetic import SyntheticInstance

__all__ = ["H5Writer", "H5Reader", "read_records"]

_VLEN_F64 = ("C", "u", "v")
_VLEN_I32 = ("rows", "cols")


def _require_h5():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py is required for HDF5 dataset IO") from exc
    return h5py


class H5Writer:
    """Append-only ragged writer."""

    def __init__(self, path: Union[str, Path]):
        h5py = _require_h5()
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = h5py.File(self.path, "w")
        vf = h5py.special_dtype(vlen=np.float64)
        vi = h5py.special_dtype(vlen=np.int32)
        vs = h5py.string_dtype()
        for key in _VLEN_F64:
            self._f.create_dataset(key, (0,), maxshape=(None,), dtype=vf)
        for key in _VLEN_I32:
            self._f.create_dataset(key, (0,), maxshape=(None,), dtype=vi)
        self._f.create_dataset("cost", (0,), maxshape=(None,), dtype=np.float64)
        self._f.create_dataset("n", (0,), maxshape=(None,), dtype=np.int64)
        self._f.create_dataset("noise_std", (0,), maxshape=(None,), dtype=np.float64)
        self._f.create_dataset("family", (0,), maxshape=(None,), dtype=vs)
        self._f.create_dataset("tag", (0,), maxshape=(None,), dtype=vs)
        self._count = 0

    def append(self, inst: SyntheticInstance) -> None:
        i = self._count
        for key in self._f:
            self._f[key].resize((i + 1,))
        self._f["C"][i] = inst.cost.reshape(-1)
        self._f["u"][i] = inst.u
        self._f["v"][i] = inst.v
        self._f["rows"][i] = inst.rows
        self._f["cols"][i] = inst.cols
        self._f["cost"][i] = float(inst.cost[inst.rows, inst.cols].sum())
        self._f["n"][i] = inst.size
        self._f["noise_std"][i] = inst.noise_std
        self._f["family"][i] = inst.family
        self._f["tag"][i] = inst.tag or ""
        self._count += 1
        if self._count % 8 == 0:
            self._f.flush()  # bound the loss if the process is killed

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class H5Reader:
    """Lazy random-access reader; ``reader[i]`` is the record of instance i
    (keys ``cost u v rows cols opt_cost n family``)."""

    def __init__(self, path: Union[str, Path]):
        h5py = _require_h5()
        self.path = Path(path)
        self._f = h5py.File(self.path, "r")

    def __len__(self) -> int:
        return self._f["n"].shape[0]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        n = int(self._f["n"][idx])
        fam = self._f["family"][idx]
        return {
            "cost": np.asarray(self._f["C"][idx], np.float64).reshape(n, n),
            "u": np.asarray(self._f["u"][idx], np.float64),
            "v": np.asarray(self._f["v"][idx], np.float64),
            "rows": np.asarray(self._f["rows"][idx], np.int32),
            "cols": np.asarray(self._f["cols"][idx], np.int32),
            "opt_cost": float(self._f["cost"][idx]),
            "n": n,
            "family": fam.decode() if isinstance(fam, bytes) else str(fam),
        }

    def iter(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]

    def sizes(self) -> np.ndarray:
        return np.asarray(self._f["n"][:], np.int64)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(paths: Sequence[Union[str, Path]]) -> List[Dict[str, Any]]:
    """Every record of every file, in order: what the training CLIs hand
    their trainers."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        with H5Reader(path) as r:
            out.extend(r.iter())
    return out
