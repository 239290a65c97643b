"""FlexServe on PyTorch and CUDA: the port of the JAX package ``repro``.

Imports torch, numpy and the standard library only; never jax and never
``repro.*``.  Entry points run on CUDA unless the caller passes
``device="cpu"``."""
