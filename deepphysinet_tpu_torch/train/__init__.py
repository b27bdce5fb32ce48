"""Train of the PyTorch port (see deepphysinet_tpu/train for the JAX reference)."""
