"""K3, the int8 packed attention: the least time of its calls in the traced
window (qkv read and output written once, 4 B H N^2 dh int8 operations, from
the shapes the model hands it) over the device time of the kernels below."""

from perfbench.readers import roofline

KERNELS = r"packed_attention_int8_(?:wgmma_)?kernel"


def read(run):
    return roofline(run, KERNELS, "k3_calls")
