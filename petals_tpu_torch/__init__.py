"""PyTorch and CUDA port of petals_tpu: a paged-KV span server for
Llama-family blocks whose attention runs through hand-written CUDA kernels
on an NVIDIA H100. Imports torch, never jax, and nothing of petals_tpu."""
