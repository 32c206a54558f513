"""K1-lse, the packed training forward: the least time of its calls in the
traced window (qkv read, output and log-sum-exp written once, 4 B H N^2 dh
bf16 operations, from the shapes the model hands it) over the device time
of the kernels below."""

from perfbench.readers import roofline

KERNELS = r"packed_(?:attention_)?lse_(?:w?g?mma_)?kernel"


def read(run):
    return roofline(run, KERNELS, "k1-lse_calls")
