"""PyTorch/CUDA port of `msvit_tpu` for one NVIDIA H100.

Mirrors the JAX package's layout and module names.  Imports torch, never
JAX and never `msvit_tpu`.  The hand-written Hopper kernels live in
`csrc/` and are built on first use (`ops/_build.py`).
"""
