"""Helpers: device choice, safetensors I/O, numpy weight conversion, the
disk caches (quantized blocks, the Hub fetcher's shards), and petals_tpu's
small utilities (logging, asyncio, packaging, sampling)."""
