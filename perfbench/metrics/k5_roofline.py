"""K5, the masked bf16 attention of the bf16 multistate forward (the exact
softmax): the least time of its calls in the traced window (q, k, v and the
f32 additive mask read once, the output written once, 4 B H N^2 dh bf16
operations) over the device time of the kernels below."""

from perfbench.readers import roofline

KERNELS = r"attention_wgmma_kernel.*FusedUnit|flash_mma_kernel|fused_attention_kernel"


def read(run):
    return roofline(run, KERNELS, "attention_calls")
