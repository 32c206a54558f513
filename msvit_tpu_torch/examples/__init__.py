"""Workflows of the port, each run as ``python -m msvit_tpu_torch.examples.<name>``
(counterparts of the JAX package's `examples/`)."""
