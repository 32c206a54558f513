"""Share of the traced window's kernel time in kernels that are neither
matrix products nor attention: LayerNorm, GELU, casts, the optimizer's
passes and the other elementwise work.  Copies and sets are not kernels."""

import re

GEMMS = r"gemm|cutlass|nvjet|xmma|cublas"
ATTENTION = r"attention|packed_lse|packed_bwd|flash_"
COPIES = r"^(?:Memcpy|Memset)"


def read(run):
    if run.trace is None:
        return None
    total = other = 0
    for s, t, name in run.trace.device:
        if re.search(COPIES, name):
            continue
        total += t - s
        if not re.search(GEMMS, name) and not re.search(ATTENTION, name):
            other += t - s
    return 100.0 * other / total if total else None
