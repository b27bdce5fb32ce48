"""Ops of the PyTorch port (see deepphysinet_tpu/ops for the JAX reference)."""
