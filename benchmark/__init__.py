"""The benchmark of the PyTorch and CUDA port (``deepphysinet_tpu_torch``); see ``run.py``."""
