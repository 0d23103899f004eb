"""PyTorch/CUDA port of the Unimem runtime and the model stack built on it.

The JAX package ``repro`` is the reference; this package imports torch and
numpy and nothing of it.
"""
