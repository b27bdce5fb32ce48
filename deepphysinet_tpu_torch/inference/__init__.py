"""Inference of the PyTorch port (see deepphysinet_tpu/inference for the JAX reference)."""
