"""Checkpoints of the port, in the JAX package's format
(``repro_torch.training.checkpoint``)."""
