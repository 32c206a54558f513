"""K2, the packed training backward (its dQ and dK/dV kernels): the least
time of its calls in the traced window (qkv, output, cotangent and
log-sum-exp read once, dqkv written once, 10 B H N^2 dh bf16 operations)
over the device time of the kernels below."""

from perfbench.readers import roofline

KERNELS = r"packed_bwd_(?:dq|dkv)_(?:w?g?mma_)?kernel"


def read(run):
    return roofline(run, KERNELS, "k2_calls")
