"""PyTorch/CUDA port of ``repro`` (rank-k Cholesky up/down-dating).

A package of its own beside the JAX package: it imports torch and nothing
of ``repro`` or ``jax``. Its entry points run on a CUDA device unless the
caller passes CPU tensors. The dense main path — ``CholFactor.update`` /
``downdate`` through ``core.api`` and ``core.backends`` to the fused chain
— runs on the hand-written CUDA kernel in ``kernels/csrc/``.
"""
