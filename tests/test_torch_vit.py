"""PyTorch port, ViT slice: the converter, the bf16/f32 trunk and the int8
serving path against the JAX package on the same weights and pixels (CPU;
JAX kernels in interpret mode via `use_kernels=True`)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.models.base import quantized as jqz
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import act_scales_from_jax, vit_params_from_jax
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base import quantized as tqz
from msvit_tpu_torch.settings import parity_policy as t_parity

SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             image_size=48, patch_size=16)  # 9 patches + CLS = 10 tokens


def _cfgs(parity=True, **kw):
    kw = {**SMALL, **kw}
    if parity:
        return JCfg(policy=j_parity(), **kw), TCfg(policy=t_parity(), **kw)
    return JCfg(**kw), TCfg(**kw)


def _pixels(seed=0, b=2, size=48):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _pair(jcfg, tcfg, seed=0):
    """JAX ViTModel params and the port ViTModel loaded with them."""
    pix = _pixels()
    params = JViT(jcfg).init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(pix))
    model = TViT(tcfg)
    model.load_state_dict(vit_params_from_jax(params, tcfg), strict=True)
    return params, model.eval()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JCfg)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TCfg)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if n == "policy":
            assert dataclasses.asdict(jd) == dataclasses.asdict(td)
        else:
            assert jd == td, n


@pytest.mark.parametrize("field,value", [("scan_layers", True)])
def test_unported_fields_raise_at_build(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TViT(TCfg(**{**SMALL, field: value}))


def test_sequence_sharding_without_a_mesh_is_a_no_op():
    """`sequence_sharding=True` builds and, with no mesh set on the model
    (`parallel.parallelize` not called), runs the unsharded trunk: the
    forward equals the plain config's bit for bit, as JAX's `constrain` is
    a no-op without an active mesh."""
    _, tcfg = _cfgs()
    plain = TViT(tcfg).eval()
    sharded = TViT(dataclasses.replace(tcfg, sequence_sharding=True)).eval()
    sharded.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_pixels())
    with torch.no_grad():
        want = plain(x)["last_hidden_state"]
        got = sharded(x)["last_hidden_state"]
    assert torch.equal(got, want)


def test_converter_layout():
    """qkv_kernel [D,3,H,dh] -> Linear [3D, D] with rows in packed
    q|k|v (t, h, e) order; Dense kernels transposed."""
    jcfg, tcfg = _cfgs()
    params, model = _pair(jcfg, tcfg)
    p = params["params"]
    sd = model.state_dict()
    w = np.asarray(p["encoder"]["layer_1"]["attention"]["qkv_kernel"])
    got = sd["encoder.layer.1.attention.qkv.weight"].numpy()
    t, h, e = 2, 3, 5
    np.testing.assert_array_equal(got[t * 64 + h * 16 + e], w[:, t, h, e])
    np.testing.assert_array_equal(
        sd["encoder.layer.0.mlp.fc1.weight"].numpy(),
        np.asarray(p["encoder"]["layer_0"]["mlp"]["fc1"]["kernel"]).T)


def test_converter_layout_moe():
    """An MoE layer: the router Dense transposed to [E, D], the expert
    arrays [E, D, F], [E, F, D] and their biases kept as they are."""
    jcfg, tcfg = _cfgs(num_experts=3)
    params, model = _pair(jcfg, tcfg)
    mlp = params["params"]["encoder"]["layer_2"]["mlp"]
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["encoder.layer.2.mlp.router.weight"].numpy(),
                                  np.asarray(mlp["router"]["kernel"]).T)
    for name in ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias"):
        np.testing.assert_array_equal(sd[f"encoder.layer.2.mlp.{name}"].numpy(),
                                      np.asarray(mlp[name]))
    assert tuple(sd["encoder.layer.0.mlp.experts_in"].shape) == (3, 64, 256)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("mask", [False, True])
def test_vit_matches_jax_parity_policy(impl, mask):
    """f32 parity policy: <= 1e-3 max abs (the repo's bar).  "auto" runs
    the port's packed path (K1 plain) against JAX's einsum path on CPU."""
    jcfg, tcfg = _cfgs(attn_implementation=impl)
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(1)
    m = None
    if mask:
        m = np.random.default_rng(2).random((2, 1, 10, 10)) < 0.8
        m |= np.eye(10, dtype=bool)[None, None]
    want = JViT(jcfg).apply(params, jnp.asarray(pix),
                            attention_mask=None if m is None else jnp.asarray(m))
    with torch.inference_mode():
        got = model(torch.from_numpy(pix),
                    attention_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_f32(got["last_hidden_state"]),
                               _f32(want["last_hidden_state"]), atol=1e-3, rtol=0)


def test_vit_outputs_attentions_and_hidden_states():
    """The einsum path's probabilities and per-layer hidden states
    (parity policy, 1e-3)."""
    jcfg, tcfg = _cfgs()
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(3)
    want = JViT(jcfg).apply(params, jnp.asarray(pix), output_attentions=True,
                            output_hidden_states=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(pix), output_attentions=True,
                    output_hidden_states=True)
    assert len(got["attentions"]) == 3 and len(got["hidden_states"]) == 4
    for a, b in zip(got["attentions"] + got["hidden_states"],
                    want["attentions"] + want["hidden_states"]):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-3, rtol=0)


def test_encoder_context_states_match_jax():
    """Per-layer context states concatenated onto K/V (parity, 1e-3)."""
    from msvit_tpu.models.base.model import BaseViTEncoder as JEnc
    from msvit_tpu_torch.compat.from_jax import _layer
    from msvit_tpu_torch.models.base.model import BaseViTEncoder as TEnc

    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ctx = [rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(3)]
    variables = JEnc(jcfg).init(jax.random.PRNGKey(5), jnp.asarray(x),
                                [jnp.asarray(c) for c in ctx])
    want, _, _ = JEnc(jcfg).apply(variables, jnp.asarray(x),
                                  [jnp.asarray(c) for c in ctx])
    sd = {}
    for i in range(3):
        _layer(sd, f"layer.{i}", variables["params"][f"layer_{i}"])
    enc = TEnc(tcfg, torch.Generator().manual_seed(0))
    enc.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got, _, _ = enc(torch.from_numpy(x), [torch.from_numpy(c) for c in ctx])
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-3, rtol=0)


def test_vit_matches_jax_default_bf16_policy():
    """Default bf16 policy: cosine >= 0.999 and max abs <= 0.25 (bf16
    rounds at other places in the two frameworks)."""
    jcfg, tcfg = _cfgs(parity=False)
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(6)
    want = _f32(JViT(jcfg).apply(params, jnp.asarray(pix))["last_hidden_state"])
    with torch.inference_mode():
        got = _f32(model(torch.from_numpy(pix))["last_hidden_state"])
    assert _cos(got, want) >= 0.999
    assert np.abs(got - want).max() <= 0.25


# ---------------------------------------------------------------- int8 ----


def _qpair():
    jcfg, tcfg = _cfgs()
    params, model = _pair(jcfg, tcfg)
    return jcfg, tcfg, jqz.quantize_vit_params(params["params"]), tqz.quantize_vit_params(model)


def test_quantize_vit_params_matches_jax():
    """int8 weights equal, scales equal (layer scales folded in)."""
    _, _, jq, tq = _qpair()
    for i in range(3):
        for site in ("qkv", "proj", "fc1", "fc2"):
            jw = jq["encoder"][f"layer_{i}"][site]["w"]
            tw = tq["encoder"][f"layer_{i}"][site]["w"]
            np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values).T)
            np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale)[0],
                                       rtol=1e-7)


def test_calibrate_act_scales_matches_jax():
    """Calibrated scales per site: rtol 1e-2."""
    jcfg, tcfg, jq, tq = _qpair()
    pix = _pixels(7)
    js = jqz.calibrate_act_scales(jq, jcfg, jnp.asarray(pix), use_kernels=True)
    ts = tqz.calibrate_act_scales(tq, tcfg, torch.from_numpy(pix), use_kernels=True)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-2)


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantized_apply_matches_jax(calibrated):
    """int8 path with kernels on (the fully-int8 attention path when
    calibrated), the JAX scales converted: cosine >= 0.999."""
    jcfg, tcfg, jq, tq = _qpair()
    pix = _pixels(8)
    js = ts = None
    if calibrated:
        js = jqz.calibrate_act_scales(jq, jcfg, jnp.asarray(pix), use_kernels=False)
        ts = act_scales_from_jax(js)
    want = _f32(jqz.quantized_vit_apply(jq, jcfg, jnp.asarray(pix),
                                        act_scales=js, use_kernels=True))
    got = tqz.quantized_vit_apply(tq, tcfg, torch.from_numpy(pix),
                                  act_scales=ts, use_kernels=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _cos(_f32(got), want) >= 0.999


def test_quantized_apply_kernels_off_uses_plain_attention():
    """use_kernels=False takes the plain attention path, as in JAX
    (cosine >= 0.999 against JAX with kernels off)."""
    jcfg, tcfg, jq, tq = _qpair()
    pix = _pixels(9)
    want = _f32(jqz.quantized_vit_apply(jq, jcfg, jnp.asarray(pix), use_kernels=False))
    got = _f32(tqz.quantized_vit_apply(tq, tcfg, torch.from_numpy(pix), use_kernels=False))
    assert _cos(got, want) >= 0.999
