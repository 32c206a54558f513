"""Ops of the port: attention (plain and packed kernels), GELU, int8."""
