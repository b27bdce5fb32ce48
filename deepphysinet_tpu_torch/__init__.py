"""DeepPhysiNet in PyTorch for NVIDIA Hopper GPUs.

A module-for-module counterpart of ``deepphysinet_tpu`` (the JAX reference):
``deepphysinet_tpu_torch.ops.coords`` mirrors ``deepphysinet_tpu.ops.coords``
and so on.  The package imports ``torch`` and never ``jax`` or ``flax``, and
nothing of the JAX package: what it needs from a jax-free module there
(``config``, ``physics/constants``) it keeps as its own copy.  Entry points run
on the first CUDA device unless the caller names another (``device.py``).
Modules carry the reference torch checkpoint's parameter names, so a reference
``.pth`` loads with ``strict=True``.

The hand-written CUDA kernels live in ``csrc/`` and are compiled with ``nvcc``
at first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

from deepphysinet_tpu_torch.version import __version__

__all__ = ["__version__"]
