"""The benchmark of implicit_tpu_torch on one CUDA card (see README.md)."""
