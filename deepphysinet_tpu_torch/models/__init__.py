"""Models of the PyTorch port (see deepphysinet_tpu/models for the JAX reference)."""
