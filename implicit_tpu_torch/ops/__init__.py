"""Device ops of the port: ALS solves, CUDA solve kernels, top-k serving."""
