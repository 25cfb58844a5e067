"""The port's weight caches (utils/quant_cache.py, utils/disk_cache.py,
utils/hub.py) against petals_tpu's: a quantized block round-trips the disk
cache bit for bit for each of the six kinds, an entry either package wrote
loads in the other and equals that package's own quantization, a port
server's warm start reads the cache instead of quantizing and serves the
tokens its cold start served (and a petals_tpu server starts from the
port's entries), a miss, a corrupt entry and a changed checkpoint are each
handled, the LRU budget evicts the coldest entry, and the Hub fetcher
streams a span's shards from a local HTTP fixture (only the shards needed,
retries, 404, traversal, the token header, LRU), as petals_tpu's does."""

import asyncio
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import quant as jq
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.utils import quant_cache as jcache
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.ops import quant as pq
from petals_tpu_torch.server.from_pretrained import load_block_params as port_load_block
from petals_tpu_torch.utils import hub
from petals_tpu_torch.utils import quant_cache as pcache
from petals_tpu_torch.utils.convert_block import convert_block_params as port_convert
from tests.test_hub import _HubHandler, hub_server, sharded_repo  # noqa: F401 (fixtures)
from tests.utils import make_tiny_llama

KINDS = ["int8", "nf4", "nf4a", "int4", "nf4a+o", "int4+o"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=2)


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf of either package, as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pieces(leaf) -> dict:
    if isinstance(leaf, (pq.OutlierQuantLinear, jq.OutlierQuantLinear)):
        return {**{f"inner.{k}": v for k, v in _pieces(leaf.inner).items()}, "idx": _bits(leaf.idx),
                "w_out": _bits(leaf.w_out)}
    if isinstance(leaf, (pq.QuantizedLinear, jq.QuantizedLinear)):
        return {"meta": (leaf.kind, leaf.in_features, leaf.out_features), "data": _bits(leaf.data),
                "scales": _bits(leaf.scales)}
    if isinstance(leaf, int):
        return {"int": leaf}
    return {"dense": _bits(leaf)}


def _assert_same_block(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for name in a:
        pa, pb = _pieces(a[name]), _pieces(b[name])
        assert sorted(pa) == sorted(pb), name
        for key in pa:
            if key.endswith(("meta", "int")):
                assert pa[key] == pb[key], (name, key)
            else:
                assert pa[key].dtype == pb[key].dtype and pa[key].shape == pb[key].shape, (name, key)
                np.testing.assert_array_equal(pa[key], pb[key], err_msg=f"{name}.{key}")


def _port_block(path, kind, block=0, fuse=True):
    return port_convert(port_load_block(path, block, dtype=torch.bfloat16, device="cpu"), "llama", kind, fuse=fuse)


def _jax_block(path, kind, block=0, fuse=True):
    return jax_convert(jax_load_block(path, block, dtype=jnp.bfloat16), "llama", kind, fuse=fuse)


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_bit_exact_and_across_packages(model_path, tmp_path, kind):
    port_params, jax_params = _port_block(model_path, kind), _jax_block(model_path, kind)
    path = pcache.cache_path(model_path, 0, kind, fuse=True, cache_dir=tmp_path, dtype_tag="bfloat16")
    # the entry's name is petals_tpu's for the same block
    assert path == jcache.cache_path(model_path, 0, kind, fuse=True, cache_dir=tmp_path, dtype_tag="bfloat16")
    pcache.save_quantized_block(path, port_params)
    loaded = pcache.load_quantized_block(path)
    _assert_same_block(loaded, port_params)  # the round trip
    _assert_same_block(jcache.load_quantized_block(path), jax_params)  # petals_tpu reads the port's entry
    other = tmp_path / "from_jax" / path.parent.name / "block.npz"
    jcache.save_quantized_block(other, jax_params)
    _assert_same_block(pcache.load_quantized_block(other), port_params)  # and the port reads petals_tpu's
    # the two files hold the same arrays under the same names
    with np.load(path) as zp, np.load(other) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert json.loads(bytes(zp["__manifest__"])) == json.loads(bytes(zj["__manifest__"]))
        for name in zp.files:
            np.testing.assert_array_equal(zp[name], zj[name], err_msg=name)


def test_miss_corruption_and_a_changed_checkpoint(model_path, tmp_path):
    miss = pcache.cache_path("nope", 3, "nf4", fuse=False, cache_dir=tmp_path)
    assert pcache.load_quantized_block(miss) is None
    miss.parent.mkdir(parents=True, exist_ok=True)
    miss.write_bytes(b"not an npz")
    assert pcache.load_quantized_block(miss) is None
    assert not miss.exists()  # a corrupt entry is dropped
    p1 = pcache.cache_path(model_path, 0, "nf4", fuse=True, cache_dir=tmp_path)
    assert p1 == pcache.cache_path(model_path, 0, "nf4", fuse=True, cache_dir=tmp_path)
    weights = [os.path.join(model_path, f) for f in os.listdir(model_path) if f.endswith(".safetensors")]
    stamps = [os.stat(f).st_mtime for f in weights]
    try:
        for f in weights:
            os.utime(f, (time.time() + 5, time.time() + 5))
        assert pcache.cache_path(model_path, 0, "nf4", fuse=True, cache_dir=tmp_path) != p1  # a new name: a miss
    finally:
        for f, t in zip(weights, stamps):
            os.utime(f, (t, t))


def test_eviction_under_the_disk_budget(model_path, tmp_path):
    params = _port_block(model_path, "int4")
    paths = [pcache.cache_path(model_path, i, "int4", fuse=True, cache_dir=tmp_path / "c") for i in range(3)]
    pcache.save_quantized_block(paths[0], params)
    entry_bytes = sum(f.stat().st_size for f in paths[0].parent.rglob("*") if f.is_file())
    pcache.save_quantized_block(paths[1], params)
    old = time.time() - 3600
    os.utime(paths[0].parent, (old, old))
    pcache.save_quantized_block(paths[2], params, max_disk_space=int(entry_bytes * 2.5))
    assert not paths[0].exists(), "the coldest entry should have been evicted"
    assert paths[1].exists() and paths[2].exists()
    os.utime(paths[1].parent, (old, old))
    assert pcache.load_quantized_block(paths[1]) is not None
    assert paths[1].parent.stat().st_atime > old + 1800  # a hit refreshes the rank


def test_warm_start_reads_the_cache_and_serves_the_same_tokens(model_path, tmp_path, monkeypatch):
    from safetensors.numpy import load_file

    from petals_tpu.rpc import RpcClient
    from petals_tpu.server import server as jax_server_mod
    from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
    from petals_tpu_torch.server import server as server_mod
    from tests.test_torch_server import _greedy

    weights = load_file(os.path.join(model_path, "model.safetensors"))
    _, cfg = jax_block_config(model_path)
    head = (weights["model.embed_tokens.weight"], weights["model.norm.weight"], weights["lm_head.weight"],
            cfg.rms_norm_eps)
    uids = " ".join(f"{server_mod.default_dht_prefix(model_path)}.{i}" for i in range(2))
    cache = tmp_path / "cache"

    async def serve(make):
        server = make()
        await server.start()
        client = await RpcClient.connect(server.rpc_server.host, server.rpc_server.port)
        try:
            return server, await _greedy(client, uids, head, [3, 17, 42, 5], 6)
        finally:
            await client.close()
            await server.shutdown()

    def port_server():
        return server_mod.Server(model_path, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32,
                                 quant_type="nf4a", cache_dir=cache, throughput=1.0, prefix_cache_bytes=0,
                                 batch_lanes=2, batch_max_length=64, page_size=16)

    cold, cold_tokens = asyncio.run(serve(port_server))
    assert cold.load_stats["cache_misses"] == 2 and cold.load_stats["cache_hits"] == 0
    calls = []
    real = server_mod.convert_block_params
    monkeypatch.setattr(server_mod, "convert_block_params", lambda *a, **k: calls.append(a) or real(*a, **k))
    warm, warm_tokens = asyncio.run(serve(port_server))
    assert warm.load_stats["cache_hits"] == 2 and not calls, "the warm start quantized again"
    assert warm_tokens == cold_tokens

    # a petals_tpu server over the port's entries: no quantization, the same tokens
    jcalls = []
    jreal = jax_server_mod.convert_block_params
    monkeypatch.setattr(jax_server_mod, "convert_block_params", lambda *a, **k: jcalls.append(a) or jreal(*a, **k))
    _, jax_tokens = asyncio.run(serve(lambda: jax_server_mod.Server(
        model_path, first_block=0, num_blocks=2, compute_dtype=jnp.float32, use_flash=False, quant_type="nf4a",
        cache_dir=cache, throughput=1.0, prefix_cache_bytes=0, prefix_device_bytes=0, batch_lanes=2,
        batch_max_length=64, page_size=16, server_side_generation=False,
    )))
    assert not jcalls, "petals_tpu quantized instead of reading the port's entries"
    assert jax_tokens == warm_tokens

    # the opt-out quantizes at every start
    calls.clear()
    off = server_mod.Server(model_path, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32,
                            quant_type="nf4a", cache_dir=cache, throughput=1.0, quant_weight_cache=False)
    off._load_span_params(0, 2)
    assert len(calls) == 2 and off.load_stats["cache_hits"] == 0


# ------------------------------------------------------------------ the Hub


def test_block_and_client_loads_stream_only_the_needed_shards(hub_server, tmp_path):
    from petals_tpu_torch.client.from_pretrained import load_client_params

    repo_id, src = hub_server
    cache = tmp_path / "cache"
    got = port_load_block(repo_id, 1, dtype=torch.float32, device="cpu", cache_dir=cache)
    want = port_load_block(src, 1, dtype=torch.float32, device="cpu")
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    files = {p.name for p in hub.repo_cache_dir(repo_id, cache).iterdir()}
    assert "model-layer1.safetensors" in files
    assert "model-layer0.safetensors" not in files and "model-client.safetensors" not in files
    from petals_tpu_torch.server.from_pretrained import resolve_model_path

    client_dir = resolve_model_path(repo_id, prefixes=("model.embed_tokens", "model.norm", "lm_head"), cache_dir=cache)
    remote = load_client_params(client_dir, dtype=torch.float32, device="cpu")
    local = load_client_params(src, dtype=torch.float32, device="cpu")
    for name in local:
        torch.testing.assert_close(remote[name], local[name], rtol=0, atol=0)


def test_a_port_server_starts_from_a_repo_id(hub_server, tmp_path):
    from petals_tpu_torch.server.server import Server

    repo_id, _ = hub_server
    cache = tmp_path / "cache"

    async def main():
        server = Server(repo_id, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32,
                        throughput=1.0, cache_dir=cache, server_side_generation=False)
        await server.start()
        try:
            return await server.handler.rpc_info({}, None)
        finally:
            await server.shutdown()

    info = asyncio.run(main())
    assert (info["first_block"], info["n_blocks"]) == (0, 2)
    files = {p.name for p in hub.repo_cache_dir(repo_id, cache).iterdir()}
    assert {"model-layer0.safetensors", "model-layer1.safetensors"} <= files
    assert "model-layer2.safetensors" not in files  # only the span's shards


def test_fetch_retries_then_gives_up(hub_server, tmp_path, monkeypatch):
    repo_id, _ = hub_server
    monkeypatch.setattr(hub, "_MAX_BACKOFF_S", 0.01)
    _HubHandler.fail_next = {"config.json": 2}
    path = hub.fetch_file(repo_id, "config.json", cache_dir=tmp_path / "a", max_retries=3)
    assert json.loads(path.read_text())["model_type"] == "llama"
    _HubHandler.fail_next = {"config.json": 100}
    with pytest.raises(OSError, match="after 2 attempts"):
        hub.fetch_file(repo_id, "config.json", cache_dir=tmp_path / "b", max_retries=1)


def test_404_once_and_cached_files_not_refetched(hub_server, tmp_path):
    repo_id, _ = hub_server
    _HubHandler.requests_seen = []
    with pytest.raises(FileNotFoundError):
        hub.fetch_file(repo_id, "no-such-file.bin", cache_dir=tmp_path, max_retries=5)
    assert len([p for p in _HubHandler.requests_seen if "no-such-file" in p]) == 1
    hub.fetch_file(repo_id, "config.json", cache_dir=tmp_path)
    _HubHandler.requests_seen = []
    hub.fetch_file(repo_id, "config.json", cache_dir=tmp_path)
    assert _HubHandler.requests_seen == []


def test_traversal_and_bad_repo_ids_refused(hub_server, tmp_path):
    repo_id, _ = hub_server
    with pytest.raises(ValueError, match="escapes"):
        hub.fetch_file(repo_id, "../../../etc/owned", cache_dir=tmp_path)
    with pytest.raises(ValueError, match="Absolute"):
        hub.fetch_file(repo_id, "/etc/owned", cache_dir=tmp_path)
    with pytest.raises(FileNotFoundError, match="repo id"):
        hub.fetch_file("/no/such/checkpoint/dir", "config.json", cache_dir=tmp_path)


def test_token_header_not_forwarded_off_host(hub_server, tmp_path, monkeypatch):
    import urllib.parse

    repo_id, _ = hub_server
    monkeypatch.setenv("HF_TOKEN", "hf_test_token")
    _HubHandler.auth_seen = []
    hub.fetch_file(repo_id, "config.json", cache_dir=tmp_path)
    assert _HubHandler.auth_seen == ["Bearer hf_test_token"]
    port = urllib.parse.urlsplit(os.environ["PETALS_TPU_HUB_ENDPOINT"]).port
    _HubHandler.redirect_host = f"localhost:{port}"
    _HubHandler.auth_seen = []
    hub.fetch_file(repo_id, "model-layer2.safetensors", cache_dir=tmp_path)
    assert _HubHandler.auth_seen[0] == "Bearer hf_test_token" and _HubHandler.auth_seen[1] is None
    _HubHandler.redirect_host = None
    assert hub.parse_size("300GB") == 300 * (1 << 30) and hub.parse_size("1024") == 1024


def test_lru_eviction_under_the_hub_budget(hub_server, tmp_path):
    repo_id, _ = hub_server
    old = tmp_path / "models--old--repo"
    old.mkdir(parents=True)
    (old / "big.bin").write_bytes(b"x" * 200_000)
    os.utime(old, (1, 1))
    hub.fetch_file(repo_id, "model-layer0.safetensors", cache_dir=tmp_path, max_disk_space=250_000)
    assert not old.exists(), "the LRU entry should have been evicted to fit the budget"
    assert (hub.repo_cache_dir(repo_id, tmp_path) / "model-layer0.safetensors").exists()


def test_cli_sets_the_hub_knobs(model_path, monkeypatch):
    from petals_tpu_torch.cli import run_server

    # main() writes these: recorded here, so that they are restored after
    monkeypatch.setenv("PETALS_TPU_MAX_DISK_SPACE", "")
    monkeypatch.setenv("HF_TOKEN", "")
    built = {}

    def build_server(args):
        built["args"] = args
        raise SystemExit(0)

    monkeypatch.setattr(run_server, "build_server", build_server)
    with pytest.raises(SystemExit):
        run_server.main([model_path, "--max_disk_space", "2KB", "--token", "hf_x", "--revision", "v2",
                         "--cache_dir", "/tmp/x", "--no_quant_weight_cache", "--no_batching"])
    args = built["args"]
    assert os.environ["PETALS_TPU_MAX_DISK_SPACE"] == "2KB" and hub.default_max_disk_space() == 2048
    assert os.environ["HF_TOKEN"] == "hf_x"
    assert (args.revision, args.cache_dir, args.no_quant_weight_cache, args.no_batching) == ("v2", "/tmp/x", True, True)
    with pytest.raises(SystemExit):
        run_server.main([model_path, "--max_disk_space", "lots"])
