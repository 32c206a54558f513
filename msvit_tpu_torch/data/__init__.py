"""Data layer of the port (the batched augmentations so far)."""
