"""Plain references, one module per model family, found by the family's name.

They import neither JAX, the JAX package nor anything of implicit_tpu_torch.
"""
