"""The port's wire and file formats against the libraries the JAX package
uses: its msgpack codec is byte-identical to ``msgpack.packb(obj,
use_bin_type=True)`` on frame-shaped objects (hypothesis-generated) and
decodes what msgpack encodes; its tensor codecs give petals_tpu's wire
dicts byte for byte (qint8 too, against petals_tpu's C++ codec, which must
have loaded); its safetensors reader and writer agree with ``safetensors``
on a tiny checkpoint; and a petals_tpu client at qint8 gets from a port
server what it gets from a petals_tpu server, and the port's client at
qint8 from a petals_tpu server what it gets from a port server."""

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


# ------------------------------------------------------------------- qint8


def _float_input(n, dtype, seed=0):
    """(numpy array, the same as a torch tensor): heavy-tailed values."""
    x = (np.random.default_rng(seed).standard_t(2, size=n) * 3).astype(np.float32)
    if dtype == "bfloat16":
        arr = x.astype(ml_dtypes.bfloat16)
        return arr, torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    arr = x.astype(dtype)
    return arr, torch.from_numpy(arr.copy())


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4097])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_qint8_wire_dicts_identical(n, dtype):
    """Bytes-equal both ways with petals_tpu's C++ codec (its numpy fallback
    divides, and can differ in the last bit: ROADMAP Queue C)."""
    from petals_tpu.native import get_lib

    assert get_lib() is not None, "petals_tpu's native qint8 codec did not load"
    arr, tensor = _float_input(n, dtype, seed=n)
    ours = tser.serialize_array(tensor.reshape(1, -1), "qint8")
    theirs = jser.serialize_array(arr.reshape(1, -1), jser.CompressionType.QINT8)
    assert ours == theirs
    back, want = tser.deserialize_array(theirs), jser.deserialize_array(ours)
    assert back.dtype == tensor.dtype and back.shape == (1, n)
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(want, np.float32))


def test_qint8_zero_block_and_non_float_tensors():
    zeros = torch.zeros(2, 1024)
    wire = tser.serialize_array(zeros, "qint8")
    assert wire == jser.serialize_array(np.zeros((2, 1024), np.float32), jser.CompressionType.QINT8)
    np.testing.assert_array_equal(np.frombuffer(wire["scales"], np.float32), np.float32(1e-8))
    assert torch.equal(tser.deserialize_array(wire), zeros)
    ints = torch.arange(6, dtype=torch.int32)
    assert tser.serialize_array(ints, "qint8") == jser.serialize_array(ints.numpy(), jser.CompressionType.QINT8)


def test_qint8_refuses_short_buffers():
    good = tser.serialize_array(torch.ones(2048), "qint8")
    for bad in ({**good, "data": good["data"][:-1]}, {**good, "scales": good["scales"][:-4]},
                {**good, "scales": good["scales"] + b"\0\0\0\0"}, {k: v for k, v in good.items() if k != "scales"}):
        with pytest.raises(ValueError, match="qint8"):
            tser.deserialize_array(bad)
        with pytest.raises((ValueError, KeyError)):
            jser.deserialize_array(bad)


@pytest.fixture(scope="module")
def qint8_route(checkpoint):
    """A port server and a petals_tpu server over the same tiny model."""
    import asyncio
    import threading

    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(300)

    import jax.numpy as jnp

    from petals_tpu.server.server import Server as JaxServer
    from petals_tpu_torch.server.server import Server

    port = Server(checkpoint, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32,
                  throughput=1.0, batch_lanes=2, batch_max_length=64, page_size=16)
    ref = JaxServer(checkpoint, first_block=0, num_blocks=2, compute_dtype=jnp.float32, use_flash=False,
                    throughput=1.0, batching=True, batch_lanes=2, batch_max_length=64, page_size=16)
    run(port.start())
    run(ref.start())
    yield run, port, ref
    run(port.shutdown())
    run(ref.shutdown())
    loop.call_soon_threadsafe(loop.stop)


def _session_replies(run, client_cls, server, compression, steps):
    """One session's replies from ``server`` through ``client_cls`` (either
    package's RpcClient), its reply compression ``compression``."""
    from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid

    async def main():
        client = await client_cls.connect("127.0.0.1", server.rpc_server.port)
        try:
            uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(2))
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": 32, "batch_size": 1, "compression": compression})
            await stream.recv(timeout=60)
            outs = []
            for h in steps:
                await stream.send({"tensors": {"hidden": tser.serialize_array(torch.from_numpy(h))}})
                reply = await stream.recv(timeout=60)
                outs.append(reply["tensors"]["hidden"])
            await stream.end()
            return outs
        finally:
            await client.close()

    return run(main())


def test_qint8_sessions_cross_serve(qint8_route, checkpoint):
    """A petals_tpu client asks a port server for qint8 replies, and the
    port's client asks a petals_tpu server: every reply is a qint8 wire
    dict that each package decodes to the same values, and each is within
    a code step (absmax_block / 254) of the same reply uncompressed."""
    from petals_tpu.rpc import RpcClient as JaxClient
    from petals_tpu_torch.rpc.client import RpcClient as PortClient

    run, port, ref = qint8_route
    rng = np.random.RandomState(2)
    steps = [rng.randn(1, n, 64).astype(np.float32) * 0.1 for n in (5, 1, 1)]
    pairs = ((JaxClient, port), (PortClient, ref))
    for client_cls, server in pairs:
        comp = _session_replies(run, client_cls, server, "qint8", steps)
        plain = _session_replies(run, client_cls, server, "none", steps)
        for wire, exact in zip(comp, plain):
            assert wire["compression"] == "qint8" and wire["wire_dtype"] == "int8"
            got = tser.deserialize_array(wire).numpy()
            np.testing.assert_array_equal(got, np.asarray(jser.deserialize_array(wire), np.float32))
            want = tser.deserialize_array(exact).numpy().reshape(-1)
            flat = got.reshape(-1)
            for b in range(0, flat.size, 1024):
                bound = np.abs(want[b:b + 1024]).max() / 254 * (1 + 2**-20) + np.spacing(np.float32(1))
                assert np.abs(flat[b:b + 1024] - want[b:b + 1024]).max() <= bound


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_qint8_clients_cross_serve(checkpoint, tmp_path, server_kind):
    """Both packages' clients at ``compression="qint8"`` over one server
    (a port server, then a petals_tpu server): they send the same qint8
    bytes, so the same server answers both alike, and every step's output
    is equal between the two clients, bit for bit."""
    from tests.test_torch_client import Route, both_clients

    route = Route(checkpoint, [(server_kind, 0, 2)], str(tmp_path), server_side_generation=False).start()
    try:
        jax_model, port_model = both_clients(checkpoint, route.initial_peers, compression="qint8")
        try:
            rng = np.random.RandomState(4)
            steps = [rng.randn(1, n, 64).astype(np.float32) for n in (6, 1, 1)]
            outs = []
            for model in (jax_model, port_model):
                got = []
                with model.remote.inference_session(max_length=16) as session:
                    for h in steps:
                        out = session.step(h if model is jax_model else torch.from_numpy(h))
                        got.append(np.asarray(out, np.float32) if model is jax_model else out.float().numpy())
                outs.append(got)
            for want, got in zip(*outs):
                np.testing.assert_array_equal(got, want)
        finally:
            port_model.close()
            jax_model.close()
    finally:
        route.stop()
