"""PyTorch/CUDA port of ``repro`` (rank-k Cholesky up/down-dating).

A package of its own beside the JAX package: it imports torch and nothing
of ``repro`` or ``jax``. Its entry points run on a CUDA device unless the
caller passes CPU tensors. ``CholFactor.update`` / ``downdate`` go
through ``core.api`` and ``core.backends`` to hand-written CUDA kernels in
``kernels/csrc/``: the fused chain (the dense main path), the paper's
per-panel cascade (``pallas``, ``pallas_gemm``) and the block-tridiagonal
chain of a structured factor (``blocktridiag``). The LM zoo (``configs``,
``data``, ``models``) and its serving driver (``launch.serve``) are plain
torch.
"""
