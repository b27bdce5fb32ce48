"""Data of the PyTorch port (see deepphysinet_tpu/data for the JAX reference)."""
