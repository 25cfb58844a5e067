"""The port's wire and file formats against the libraries the JAX package
uses: its msgpack codec is byte-identical to ``msgpack.packb(obj,
use_bin_type=True)`` on frame-shaped objects (hypothesis-generated) and
decodes what msgpack encodes; its tensor codecs give petals_tpu's wire
dicts byte for byte; its safetensors reader and writer agree with
``safetensors`` on a tiny checkpoint."""

import os

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import load_file as st_load_torch

from petals_tpu.rpc import serialization as jser
from petals_tpu_torch.rpc import msgpack_codec, serialization as tser
from petals_tpu_torch.utils import safetensors_io
from tests.utils import make_tiny_llama

scalars = (
    st.none() | st.booleans() | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=True, allow_infinity=True) | st.text(max_size=300)
    | st.binary(max_size=70000)
)
values = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20) | st.dictionaries(st.text(max_size=40) | st.integers(-5, 5), inner, max_size=20),
    max_leaves=40,
)
frames = st.fixed_dictionaries(
    {"t": st.sampled_from(["hello", "req", "resp", "sopen", "sitem", "send", "cancel"]),
     "id": st.integers(min_value=0, max_value=2**40)},
    optional={"method": st.text(max_size=30), "payload": values, "ok": st.booleans(),
              "error": st.text(max_size=200)},
)


@settings(max_examples=150, deadline=None)
@given(frames)
def test_msgpack_bytes_identical(frame):
    ours = msgpack_codec.packb(frame)
    assert ours == msgpack.packb(frame, use_bin_type=True)
    assert msgpack_codec.packb(msgpack_codec.unpackb(ours)) == ours
    assert msgpack_codec.packb(msgpack.unpackb(ours, raw=False, strict_map_key=False)) == ours


@pytest.mark.parametrize("n", [0, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_length_boundaries(n):
    for obj in ("x" * n, b"y" * n, [1] * min(n, 70000), {i: None for i in range(min(n, 70000))}):
        assert msgpack_codec.packb(obj) == msgpack.packb(obj, use_bin_type=True)
        assert msgpack_codec.unpackb(msgpack.packb(obj, use_bin_type=True)) == (
            list(obj) if isinstance(obj, list) else obj
        )


def test_msgpack_rejects_what_frames_never_carry():
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": object()})
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(b"\xd9\x10abc")  # truncated str


@pytest.mark.parametrize("compression", ["none", "float16", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_wire_dicts_identical(compression, dtype):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((2, 3, 8)).astype(np.float32)
    if dtype == "bfloat16":
        arr = arr.astype(ml_dtypes.bfloat16)
        tensor = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif dtype == "int32":
        arr = (arr * 100).astype(np.int32)
        tensor = torch.from_numpy(arr)
    else:
        tensor = torch.from_numpy(arr)
    ours = tser.serialize_array(tensor, compression)
    theirs = jser.serialize_array(arr, jser.CompressionType(compression))
    assert ours == theirs
    # and each side decodes the other's bytes to the same values
    back = tser.deserialize_array(theirs)
    want = jser.deserialize_array(ours)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(want, np.float32))


def test_deserialize_rejects_bad_wire():
    good = tser.serialize_array(torch.zeros(4))
    with pytest.raises(ValueError):
        tser.deserialize_array({**good, "data": good["data"][:-1]})
    with pytest.raises(ValueError):
        tser.deserialize_array({**good, "dtype": "complex64"})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=2)


def test_safetensors_reader_and_writer(checkpoint, tmp_path):
    path = os.path.join(checkpoint, "model.safetensors")
    want = st_load_torch(path)
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name], want[name]), name
    # the writer's file reads back through safetensors, bf16 bits intact
    tensors = {"a": want["model.norm.weight"].to(torch.bfloat16), "b": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    out = str(tmp_path / "w.safetensors")
    safetensors_io.save_file(tensors, out, metadata={"format": "pt"})
    back = st_load_torch(out)
    assert torch.equal(back["a"], tensors["a"]) and torch.equal(back["b"], tensors["b"])
    np.testing.assert_array_equal(st_load_numpy(out)["b"], tensors["b"].numpy())
