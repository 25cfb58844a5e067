"""Tensor ops: attention, rotary embeddings, the paged KV cache and the
wrappers of the CUDA paged-attention kernels."""
