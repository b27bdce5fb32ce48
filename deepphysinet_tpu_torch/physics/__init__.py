"""Physics of the PyTorch port (see deepphysinet_tpu/physics for the JAX reference)."""
