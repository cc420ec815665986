"""Kernels of the port: CUDA sources in ``csrc/``, wrappers and their plain
torch versions beside them. Nothing is built at import."""
