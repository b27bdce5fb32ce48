"""DeepPhysiNet in PyTorch for NVIDIA Hopper GPUs.

A module-for-module counterpart of ``deepphysinet_tpu`` (the JAX reference):
``deepphysinet_tpu_torch.ops.coords`` mirrors ``deepphysinet_tpu.ops.coords``
and so on.  The package imports ``torch`` and never ``jax`` or ``flax``; of the
JAX package it uses only the jax-free ``deepphysinet_tpu.config``.  Modules
carry the reference torch checkpoint's parameter names, so a reference
``.pth`` loads with ``strict=True``.

The hand-written CUDA kernels live in ``csrc/`` and are compiled with ``nvcc``
at first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""
