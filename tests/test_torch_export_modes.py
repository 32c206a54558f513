"""Export of the clustered families' other attention routes on the CPU
(the rest of `tests/test_torch_export_families.py`, in a file of its own so
that the two files' exports run on two test workers): the int8
`quantized_multistate_apply` with `attn_mode="int8"` (K9), the banded
multistate model (K10) and a tiny subsample forward whose flash attention
(K7) reads a key-only mask, each exported with a symbolic batch: the graph
holds the kernel's `torch.ops.msvit.*` node, and the reload equals the live
forward bit for bit at batches 1, 2 and 5."""

import io
import zipfile

import pytest
import torch

from msvit_tpu_torch.export import export_forward, load_forward
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.models import subsample as tss
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.utils.rng import Rng
from test_torch_export import _graph_ops
from test_torch_export_families import _bit_equal_at, _outputs, _port_model, _x


# ---------------------------------- (d) int8 (K9), banded (K10), subsample (K7)


def _int8_forward():
    tcfg, model = _port_model()
    tq = tms.quantize_multistate_params(model)
    scales = tms.calibrate_multistate_act_scales(tq, tcfg, _x(2), Rng(0))

    def fn(p, x):
        out = tms.quantized_multistate_apply(p["w"], tcfg, x, Rng(7), act_scales=p["s"],
                                             use_kernels=True, attn_mode="int8")
        return _outputs(out)

    return fn, {"w": tq, "s": scales}, "msvit.packed_attention_int8_masked.default"


def _banded_forward():
    _, model = _port_model(banded_attention=True)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(p, x):
        return _outputs(torch.func.functional_call(model, p, (x,), {"rng": Rng(11)}))

    return fn, params, "msvit.token_rows.default"


def _subsample_forward():
    cfg = tss.SubsampleViTConfig(
        hidden_size=64, num_hidden_layers=1, num_attention_heads=4, image_size=64,
        patch_size=8, initial_grid_size=2, multiplicative_grid_size=2, max_depth=1,
        attn_implementation="flash", policy=t_parity())
    model = tss.SubsampleViTModel(cfg, generator=torch.Generator().manual_seed(2)).eval()
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(p, x):
        out = torch.func.functional_call(model, p, (x,), {"rng": Rng(3)})
        return out["last_hidden_state"], out["last_valid_mask"], out["log_prob"]

    return fn, params, "msvit.flash_attention.default"


@pytest.mark.parametrize("family", ["int8", "banded", "subsample"])
def test_family_artifacts_are_bit_equal_to_live(family):
    """The int8 apply with `attn_mode="int8"` (K9), the banded model (K10)
    and the subsample forward (K7 under a key-only mask, one node per
    layer and pass), each exported with a symbolic batch: the graph
    holds the kernel's node, and the reload equals the live forward bit
    for bit at batches 1, 2 and 5.  The subsample graph's key-only masks
    stay [B, 1, 1, Nk]: one row per image, never expanded."""
    fn, params, node = {"int8": _int8_forward, "banded": _banded_forward,
                        "subsample": _subsample_forward}[family]()
    art = export_forward(fn, (params, _x(2)), polymorphic_batch=True)
    ops = _graph_ops(art)
    # one layer with a kernel: the multistate trunk's first (the last layer
    # takes the plain path); the subsample trunk's only one, in each of its
    # two passes
    assert ops.count(node) == (2 if family == "subsample" else 1), ops.count(node)
    if family == "subsample":
        with zipfile.ZipFile(io.BytesIO(art)) as z:
            ep = torch.export.load(io.BytesIO(z.read("program_cpu.pt2")))
        masks = [n.args[3].meta["val"].shape for n in ep.graph.nodes
                 if str(n.target) == node]
        assert all(tuple(m[1:3]) == (1, 1) for m in masks), masks
    _bit_equal_at(load_forward(art), fn, params)
