"""Shared constants (petals_tpu/constants.py), with torch dtypes."""

import torch

# Bootstrap peers of a public swarm: private swarms by default, so none.
PUBLIC_INITIAL_PEERS: list = []

# Reserved for a health-monitor endpoint; a server exposes the same
# information through its DHT records and ``ptu.info``.
REACHABILITY_API_URL = None

# String names <-> torch dtypes used on the wire and in configs.
DTYPE_MAP = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "auto": "auto",
}

DTYPE_NAMES = {v: k for k, v in DTYPE_MAP.items() if k != "auto"}

# Checkpoint file names shared by the local loader (server/from_pretrained.py)
# and the streaming Hub fetcher (utils/hub.py), so that the downloader's and
# the reader's notion of "a checkpoint" cannot diverge.
SAFE_INDEX = "model.safetensors.index.json"
SAFE_SINGLE = "model.safetensors"
BIN_INDEX = "pytorch_model.bin.index.json"
BIN_SINGLE = "pytorch_model.bin"
