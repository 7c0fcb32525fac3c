"""The port's MessagePack codec (``..._torch/serialization.py``) against
flax's: the bytes it writes equal ``flax.serialization.msgpack_serialize``'s
for the same tree, and it decodes what flax writes, chunked leaves
included."""

import io
import zlib

import numpy as np
import pytest
import torch

import flax.serialization
import jax.numpy as jnp
from flax import serialization as fs

from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    serialization as S,
)

DTYPES = ["float32", "float16", "int32", "int64", "uint32", "uint8", "bool"]


def _tree(seed=0):
    """Every kind of value flax writes, at the size edges of each
    MessagePack encoding, in the shape of a checkpoint shard payload."""
    rng = np.random.default_rng(seed)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "format": 2, "process": 3, "ints": ints, "floats": [0.0, -1.5, 1e300],
        "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "héllo"],
        "blobs": [b"", b"\x00\x01", b"q" * 300], "none": None,
        "flags": [True, False],
        "leaves": {f".params['l{i}']['kernel']": [
            [[[0, 1], [0, 3], [0, 2]],
             rng.normal(size=(1, 3, 2)).astype(np.float32).transpose(
                 0, 2, 1)]] for i in range(20)},
        "arrays": {d: (rng.normal(size=(2, 3)) * 9).astype(d)
                   for d in DTYPES},
        "edge": {"empty": np.zeros((0, 4), np.float32),
                 "zero_d": np.array(3.5, np.float32),
                 "big": rng.normal(size=(20000,)).astype(np.float32)},
        "scalars": {"f": np.float32(2.5), "i": np.int64(-7),
                    "b": np.bool_(True), "u": np.uint32(9)},
        "long_list": list(range(70000)),
        "wide_map": {str(i): i for i in range(20)},
    }


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_bytes_equal_flax_msgpack_serialize():
    tree = _tree()
    want = fs.msgpack_serialize(tree)
    assert S.dumps(tree) == want
    f = io.BytesIO()
    n, crc = S.write(f, tree)
    assert (f.getvalue(), n, crc) == (want, len(want), zlib.crc32(want))


def test_decodes_flax_bytes():
    raw = fs.msgpack_serialize(_tree(1))
    assert _same(S.loads(raw), fs.msgpack_restore(raw))


@pytest.mark.parametrize("where", ["map_value", "top_level"])
def test_chunked_leaves_match_flax(monkeypatch, where):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into flat pieces (map
    values and a bare array; arrays inside lists are not chunked): the
    port writes the same bytes and joins the pieces back on read."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(S, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    big = rng.normal(size=(7, 5)).astype(np.float32)
    tree = ({"w": big, "in_list": [big], "nested": {"v": big[:, :3]}}
            if where == "map_value" else big)
    raw = fs.msgpack_serialize(tree)
    assert S.dumps(tree) == raw
    back = S.loads(raw)
    if where == "map_value":
        assert _same(back, {"w": big, "in_list": [big],
                            "nested": {"v": big[:, :3]}})
    else:
        np.testing.assert_array_equal(back, big)


def test_bfloat16_through_a_uint16_view():
    """A torch bfloat16 leaf is written as flax writes a jnp.bfloat16
    array (dtype name ``bfloat16``) and reads back as a torch.bfloat16
    tensor, bit for bit, without ml_dtypes."""
    x = torch.randn(3, 4).to(torch.bfloat16)
    ref = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    raw = fs.msgpack_serialize({"x": ref})
    assert S.dumps({"x": x}) == raw
    back = S.loads(raw)["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64,
                                   torch.uint8, torch.bool],
                         ids=["f32", "i32", "i64", "u8", "bool"])
def test_torch_leaves_write_numpy_bytes(dtype):
    t = (torch.arange(12).reshape(3, 4) % 5).to(dtype).t()   # a view
    assert S.dumps({"t": t}) == fs.msgpack_serialize(
        {"t": np.ascontiguousarray(t.numpy())})


@pytest.mark.parametrize("bad", [{1: 2}, {"x": object()},
                                 {"x": np.zeros(2, np.complex64)}],
                         ids=["int_key", "object", "complex"])
def test_refuses_what_flax_format_cannot_hold(bad):
    with pytest.raises((TypeError, ValueError)):
        S.dumps(bad)


def test_truncated_input_raises():
    raw = fs.msgpack_serialize(_tree(3))
    with pytest.raises(ValueError):
        S.loads(raw[:-7])
    with pytest.raises(ValueError):
        S.loads(raw + b"\xc0")
