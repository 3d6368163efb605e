"""The port's msgpack checkpoint format against flax's for chunked arrays.

flax writes an array above ``flax.serialization.MAX_CHUNK_SIZE`` bytes as a
map of flat chunks; the port's writer and reader
(``lapgnn_tpu_torch.train.checkpoint``) must produce and accept the same
bytes.  Both limits are patched down to a few bytes, so that small arrays
take the chunked form.
"""

import numpy as np
import pytest
from flax import serialization

from lapgnn_tpu_torch.train import checkpoint as tckpt

CHUNK_BYTES = (4, 40, 64)


def _tree():
    rng = np.random.default_rng(3)
    return {
        "dense": {
            "kernel": rng.standard_normal((7, 9)).astype(np.float32),  # 63: no multiple
            "bias": rng.standard_normal((12,)).astype(np.float32),
        },
        "f64": rng.standard_normal((3, 4)),
        "ids": np.arange(25, dtype=np.int32).reshape(5, 5) - 7,
        "mask": rng.random((6, 11)) < 0.5,
        "scalar": np.array(2.5),
        "scalar32": np.array(-1.25, np.float32),
        "deep": np.arange(3, dtype=np.float64).reshape((1,) * 10 + (3,)),  # an 11-entry shape map
        "empty": np.zeros((0, 4), np.float32),
        "leaf": np.float32(7.0),
    }


@pytest.fixture
def chunk_bytes(request, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", request.param)
    monkeypatch.setattr(tckpt, "_MAX_CHUNK_BYTES", request.param)
    return request.param


def _assert_same_tree(got, want):
    assert type(got) is type(want) or (isinstance(got, dict) and isinstance(want, dict))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("chunk_bytes", CHUNK_BYTES, indirect=True)
def test_chunked_writer_is_byte_equal_to_flax(chunk_bytes):
    tree = _tree()
    want = serialization.msgpack_serialize(_tree())
    assert b"__msgpack_chunked_array__" in want
    assert tckpt.msgpack_serialize(tree) == want
    _assert_same_tree(tree, _tree())  # the caller's tree is left as it was


@pytest.mark.parametrize("chunk_bytes", CHUNK_BYTES, indirect=True)
def test_chunked_reader_restores_flax_bytes(chunk_bytes):
    raw = serialization.msgpack_serialize(_tree())
    got = tckpt.msgpack_restore(raw)
    _assert_same_tree(got, serialization.msgpack_restore(raw))
    _assert_same_tree(got, _tree())


@pytest.mark.parametrize("chunk_bytes", CHUNK_BYTES, indirect=True)
def test_chunked_checkpoint_round_trip(chunk_bytes, tmp_path):
    meta = {"architecture": "one_gnn", "hidden": 8}
    tckpt.save_checkpoint(tmp_path, _tree(), meta)
    params, meta2, opt = tckpt.load_checkpoint(tmp_path)
    assert meta2 == meta and opt is None
    _assert_same_tree(params, _tree())
    raw = (tmp_path / "params.msgpack").read_bytes()
    _assert_same_tree(serialization.msgpack_restore(raw), _tree())


@pytest.mark.parametrize("chunk_bytes", [40], indirect=True)
def test_chunked_top_level_array(chunk_bytes):
    arr = np.arange(37, dtype=np.float32).reshape(37, 1)
    want = serialization.msgpack_serialize(arr)
    assert tckpt.msgpack_serialize(arr) == want
    _assert_same_tree(tckpt.msgpack_restore(want), arr)


def test_unchunked_below_the_limit():
    tree = _tree()
    raw = tckpt.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" not in raw
    assert raw == serialization.msgpack_serialize(_tree())
