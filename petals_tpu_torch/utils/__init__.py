"""Helpers: device choice, safetensors I/O, numpy weight conversion."""
