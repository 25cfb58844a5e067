"""Server throughput self-measurement (the port's copy of
petals_tpu/server/throughput.py), per block, through the port's own serving
backend on the device that will serve, with the same quantization:

- inference_rps: one-token decode steps a second, on the path that will
  serve them. A paged server (the default) steps ``paged_decode_step`` on a
  one-lane pool of its page size and KV encoding; a ``page_size=0`` server
  steps ``inference_step`` on a dense cache (petals_tpu measures its dense
  ``inference_step`` whatever its pool; the port's dense decode attention is
  plain PyTorch, not the paged kernel, so the number must describe the path
  that serves). On a card both are replays of their step programs (CUDA
  graphs), each timed after the calls that run its key eagerly and capture
  it. A replayed dense decode step of 8 Mistral-7B blocks on an H100 takes
  3.7-3.9 ms of device time against the paged step's 2.6 ms, a third of it
  the plain decode attention (chip_smoke.py's profile phase; PERF.md
  section 5).
- forward_rps: tokens a second of ``forward`` at 1024 tokens, on a card
  replays of its step program as well.
- network_rps: the requests a second the wire carries, from the swarm
  bandwidth probe (utils/bandwidth.py), ``network_mbps`` or, alone, a
  loopback serialization and framing probe.

The compute figures are cached in an fcntl-locked JSON file of the port's
own (``$PETALS_TPU_TORCH_CACHE``, default ~/.cache/petals_tpu_torch), keyed
by the model's shape, the dtype, the quantization, the decode path and how
it runs (graph replays or eager), the port's version and the card's name, so the two packages never read each
other's numbers. The network figure is never cached.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

import torch

import petals_tpu_torch

logger = logging.getLogger(__name__)

THROUGHPUT_FILE = "throughput_v1.json"
PROBE_CACHE_TOKENS = 256  # the decode probe's cache length, as petals_tpu's
FORWARD_TOKENS = 1024


def default_cache_dir() -> Path:
    return Path(os.environ.get("PETALS_TPU_TORCH_CACHE") or Path.home() / ".cache" / "petals_tpu_torch")


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def get_server_throughput(
    family,
    cfg,
    *,
    device,
    compute_dtype: torch.dtype = torch.bfloat16,
    quant_type: str = "none",
    kv_quant_type: str = "none",
    page_size: int = 64,
    network_mbps: Optional[float] = None,
    num_blocks: int = 1,
    cache_dir: Optional[Path] = None,
) -> dict:
    """Returns {"throughput", "inference_rps", "forward_rps", "network_rps"}:
    ``throughput`` is the smaller of the compute rate spread over the hosted
    blocks and the network rate. No relay is priced: the port has none yet."""
    device = torch.device(device)
    cache_dir = Path(cache_dir or default_cache_dir())
    cache_dir.mkdir(parents=True, exist_ok=True)
    cache_path = cache_dir / THROUGHPUT_FILE
    # every field that changes the measured speed is in the key: a stale
    # number would mis-drive routing and placement swarm-wide
    cache_key = json.dumps(
        {
            "family": family.name,
            "hidden": cfg.hidden_size,
            "intermediate": cfg.intermediate_size,
            "kv_heads": cfg.num_key_value_heads,
            "head_dim": cfg.head_dim,
            "layers_probed": 1,
            "dtype": str(compute_dtype).removeprefix("torch."),
            "quant": str(quant_type),
            "decode": f"paged:{page_size}:{kv_quant_type}" if page_size else "dense",
            # every step on a card replays a CUDA graph (the dense decode
            # step and the forward too): a number timed on the eager block
            # loop is not reused for it
            "step": "cuda_graph" if device.type == "cuda" else "eager",
            "forward": "cuda_graph" if device.type == "cuda" else "eager",
            "version": petals_tpu_torch.__version__,
            "backend": device.type,
            "device_name": _device_name(device),
        },
        sort_keys=True,
    )
    cache = _read_cache(cache_path)
    if cache_key in cache:
        info = dict(cache[cache_key])
        logger.info(f"Using cached compute throughput: {info}")
    else:
        info = measure_compute_rps(
            family, cfg, device=device, compute_dtype=compute_dtype, quant_type=quant_type,
            kv_quant_type=kv_quant_type, page_size=page_size,
        )
        cache[cache_key] = info
        _write_cache(cache_path, cache)
    info["network_rps"] = measure_network_rps(cfg.hidden_size, network_mbps=network_mbps)
    compute_rps = info["forward_rps"] / max(num_blocks, 1)
    return {
        "throughput": min(compute_rps, info["network_rps"]),
        "inference_rps": info["inference_rps"],
        "forward_rps": info["forward_rps"],
        "network_rps": info["network_rps"],
    }


def _random_block(family, cfg, device, dtype, quant_type: str) -> dict:
    """One block of seeded random weights, quantized and fused as the server
    serves it."""
    from petals_tpu_torch.utils.convert_block import convert_block_params

    gen = torch.Generator(device=device).manual_seed(0)
    params = {
        name: (torch.randn(meta.shape, generator=gen, device=device) * 0.02).to(dtype)
        for name, meta in sorted(family.block_param_shapes(cfg, dtype).items())
    }
    return convert_block_params(params, family.name, quant_type, fuse=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def measure_compute_rps(
    family, cfg, *, device, compute_dtype: torch.dtype = torch.bfloat16, quant_type: str = "none",
    kv_quant_type: str = "none", page_size: int = 64, n_steps_inference: int = 50, n_steps_forward: int = 5,
) -> dict:
    """Time one block through the port's serving backend on ``device``."""
    from petals_tpu_torch.ops.paged_attention import PagedPool
    from petals_tpu_torch.server.backend import TransformerBackend

    device = torch.device(device)
    backend = TransformerBackend(
        family, cfg, [_random_block(family, cfg, device, compute_dtype, quant_type)],
        first_block=0, n_blocks=1, device=device, compute_dtype=compute_dtype,
        quant_type=quant_type, kv_quant_type=kv_quant_type,
    )
    token = torch.zeros(1, 1, cfg.hidden_size, dtype=compute_dtype, device=device)
    if page_size:
        n_pages = -(-PROBE_CACHE_TOKENS // page_size)
        bufs = [d.make_zeros() for d in backend.paged_cache_descriptors(n_pages, page_size, 0, 1)]
        pool = (PagedPool(bufs[0], bufs[2]), PagedPool(bufs[1], bufs[3])) if len(bufs) == 4 else tuple(bufs)
        tables = torch.arange(n_pages, dtype=torch.int32, device=device)[None]

        def step(i, pool):
            positions = torch.full((1,), i, dtype=torch.int32, device=device)
            return backend.paged_decode_step(token, pool, positions, tables)
    else:
        pool = tuple(d.make_zeros() for d in backend.cache_descriptors(1, PROBE_CACHE_TOKENS, 0, 1))

        def step(i, pool):
            return backend.inference_step(token, pool, i)

    # a step program's key runs eagerly (dense) or captures on its first
    # calls: both stay off the clock
    for i in range(2):
        out, pool = step(i, pool)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(n_steps_inference):
        out, pool = step(i + 2, pool)
    _sync(device)
    inference_rps = n_steps_inference / (time.perf_counter() - t0)

    batch = torch.zeros(1, FORWARD_TOKENS, cfg.hidden_size, dtype=compute_dtype, device=device)
    for _ in range(2):
        backend.forward(batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps_forward):
        out = backend.forward(batch)
    _sync(device)
    forward_rps = n_steps_forward * FORWARD_TOKENS / (time.perf_counter() - t0)
    logger.info(
        f"Measured compute on {_device_name(device)}: inference {inference_rps:.1f} steps/s "
        f"({'paged' if page_size else 'dense'} decode), forward {forward_rps:.0f} tokens/s per block"
    )
    return {"inference_rps": inference_rps, "forward_rps": forward_rps}


def measure_network_rps(hidden_size: int, *, network_mbps: Optional[float] = None) -> float:
    """Tokens a second the wire carries at 16 bits an activation element."""
    if network_mbps is None:
        network_mbps = _loopback_serialization_mbps(hidden_size)
    return network_mbps * 1e6 / (hidden_size * 16)


def _loopback_serialization_mbps(hidden_size: int) -> float:
    """Our own serialize -> frame -> deserialize path as the bandwidth
    ceiling, capped at 10 Gbit/s."""
    from petals_tpu_torch.rpc.protocol import encode_frame
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    arr = torch.randn(1, FORWARD_TOKENS, hidden_size).to(torch.float16)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        wire = serialize_array(arr)
        frame = encode_frame({"tensors": {"hidden": wire}})
        deserialize_array(wire)
    mbps = n * len(frame) * 8 / (time.perf_counter() - t0) / 1e6
    return min(mbps, 10_000.0)


def _read_cache(path: Path) -> dict:
    try:
        with open(path) as f:
            fcntl.flock(f, fcntl.LOCK_SH)
            try:
                return json.load(f)
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def _write_cache(path: Path, cache: dict) -> None:
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            json.dump(cache, f)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
