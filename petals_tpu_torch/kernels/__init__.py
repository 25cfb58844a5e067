"""Build and load the CUDA sources under ``csrc/`` (nvcc + ctypes)."""
