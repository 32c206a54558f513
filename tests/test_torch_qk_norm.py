"""PyTorch port, qk-norm (`BaseViTConfig.qk_norm`: a per-head LayerNorm
over dh on q and on every key, learnable scale, no bias) against the JAX
package on the same weights and inputs, on both attention paths: the packed
path (the norm is a row operation on the QKV GEMM output and 1/sqrt(dh)
multiplies the normed q) and the einsum path (q and k normed before the
dispatch, context keys included).  Parity policy, <= 1e-3 max abs."""

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import msvit_tpu.models.base.model as jmodel
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.models.base.vit import ViTForImageClassification as JCls
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import classifier_params_from_jax, vit_params_from_jax
from msvit_tpu_torch.compat.from_jax import _layer
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTForImageClassification as TCls
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base import quantized as tqz
from msvit_tpu_torch.settings import parity_policy as t_parity

SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             image_size=48, patch_size=16, qk_norm=True)  # 9 patches + CLS
LABELS = 7


def _cfgs(parity=True, **kw):
    kw = {**SMALL, **kw}
    if parity:
        return JCfg(policy=j_parity(), **kw), TCfg(policy=t_parity(), **kw)
    return JCfg(**kw), TCfg(**kw)


def _pixels(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 48, 48, 3)).astype(np.float32)


def _live_norms(params, seed=1):
    """Random q/k norm scales around 1, so a dropped or misplaced norm or
    scale shows."""
    rng = np.random.default_rng(seed)

    def bump(kp, x):
        if any("q_norm" in str(k) or "k_norm" in str(k) for k in kp):
            return x + jnp.asarray(rng.uniform(-0.5, 0.5, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(bump, params)


def _pair(jcfg, tcfg, seed=0):
    params = JViT(jcfg).init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(_pixels()))
    params = _live_norms(params)
    model = TViT(tcfg)
    model.load_state_dict(vit_params_from_jax(params, tcfg), strict=True)
    return params, model.eval()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mask():
    m = np.random.default_rng(2).random((2, 1, 10, 10)) < 0.8
    return m | np.eye(10, dtype=bool)[None, None]


def test_converter_layout_and_build():
    """`q_norm/scale` and `k_norm/scale` [dh] of each layer become
    `attention.{q,k}_norm.weight`; the model has them only under qk_norm."""
    jcfg, tcfg = _cfgs()
    params, model = _pair(jcfg, tcfg)
    sd = model.state_dict()
    for i in range(3):
        attn = params["params"]["encoder"][f"layer_{i}"]["attention"]
        for name in ("q_norm", "k_norm"):
            got = sd[f"encoder.layer.{i}.attention.{name}.weight"]
            assert got.shape == (16,)
            np.testing.assert_array_equal(got.numpy(), np.asarray(attn[name]["scale"]))
            assert f"encoder.layer.{i}.attention.{name}.bias" not in sd
    plain = TViT(TCfg(**{**SMALL, "qk_norm": False})).state_dict()
    assert not any("q_norm" in k or "k_norm" in k for k in plain)
    assert set(sd) - set(plain) == {
        f"encoder.layer.{i}.attention.{n}.weight" for i in range(3)
        for n in ("q_norm", "k_norm")}


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("mask", [False, True])
def test_qk_norm_vit_matches_jax(impl, mask):
    """The port's packed path ("auto": K1's plain version) and its einsum
    path ("xla") against JAX's einsum path (what JAX takes off the TPU)."""
    jcfg, tcfg = _cfgs(attn_implementation=impl)
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(3)
    m = _mask() if mask else None
    want = JViT(jcfg).apply(params, jnp.asarray(pix),
                            attention_mask=None if m is None else jnp.asarray(m))
    with torch.inference_mode():
        got = model(torch.from_numpy(pix),
                    attention_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_f32(got["last_hidden_state"]),
                               _f32(want["last_hidden_state"]), atol=1e-3, rtol=0)


@pytest.mark.parametrize("mask", [False, True])
def test_qk_norm_packed_path_matches_jax_packed_path(monkeypatch, mask):
    """JAX's own packed path (its Pallas kernel in interpret mode, reached
    by answering `_packed_available` for it: nothing in the package changes)
    against the port's: the scale fold after the norm on both sides."""
    monkeypatch.setattr(jmodel, "_packed_available", lambda: True)
    jcfg, tcfg = _cfgs(attn_implementation="packed")
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(4)
    m = _mask() if mask else None
    want = JViT(jcfg).apply(params, jnp.asarray(pix),
                            attention_mask=None if m is None else jnp.asarray(m))
    with torch.inference_mode():
        got = model(torch.from_numpy(pix),
                    attention_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_f32(got["last_hidden_state"]),
                               _f32(want["last_hidden_state"]), atol=1e-3, rtol=0)


def test_packed_path_equals_einsum_path_and_norms_are_live():
    """Within the port: the packed path equals the einsum path (1e-5; the
    q-prescale buffer must not be applied on top of the norm), and zeroing
    a q-norm scale changes the output."""
    jcfg, tcfg = _cfgs()
    params, packed = _pair(jcfg, tcfg)
    einsum = TViT(TCfg(**{**SMALL, "attn_implementation": "xla"}, policy=t_parity())).eval()
    einsum.load_state_dict(packed.state_dict())
    pix = torch.from_numpy(_pixels(5))
    with torch.inference_mode():
        a = packed(pix)["last_hidden_state"]
        b = einsum(pix)["last_hidden_state"]
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        packed.encoder.layer[0].attention.q_norm.weight.zero_()
        c = packed(pix)["last_hidden_state"]
    assert (a - c).abs().max() > 1e-4


def test_encoder_context_states_match_jax():
    """The einsum path with per-layer context states: the context keys are
    normed too."""
    from msvit_tpu.models.base.model import BaseViTEncoder as JEnc
    from msvit_tpu_torch.models.base.model import BaseViTEncoder as TEnc

    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ctx = [rng.standard_normal((2, 5, 64)).astype(np.float32) * 3.0 for _ in range(3)]
    variables = JEnc(jcfg).init(jax.random.PRNGKey(7), jnp.asarray(x),
                                [jnp.asarray(c) for c in ctx])
    variables = _live_norms(variables)
    want, _, _ = JEnc(jcfg).apply(variables, jnp.asarray(x), [jnp.asarray(c) for c in ctx])
    sd = {}
    for i in range(3):
        _layer(sd, f"layer.{i}", variables["params"][f"layer_{i}"])
    enc = TEnc(tcfg, torch.Generator().manual_seed(0))
    enc.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got, _, _ = enc(torch.from_numpy(x), [torch.from_numpy(c) for c in ctx])
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-3, rtol=0)


def test_qk_norm_default_bf16_policy():
    """bf16 compute: cosine >= 0.999 and max abs <= 0.25 (bf16 rounds at
    other places in the two frameworks)."""
    jcfg, tcfg = _cfgs(parity=False)
    params, model = _pair(jcfg, tcfg)
    pix = _pixels(8)
    want = _f32(JViT(jcfg).apply(params, jnp.asarray(pix))["last_hidden_state"])
    with torch.inference_mode():
        got = _f32(model(torch.from_numpy(pix))["last_hidden_state"])
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999
    assert np.abs(got - want).max() <= 0.25


@pytest.mark.parametrize("blow_up", [1.0, 1000.0])
def test_classifier_grad_matches_jax_at_large_qk_weights(blow_up):
    """The case qk-norm exists for: the QKV projection scaled by 1000 (the
    logits would be in the millions without the norm).  Logits 1e-4 of
    their scale, loss 1e-4 relative, every gradient finite and within 1e-3
    of the largest |g| of `jax.value_and_grad` (the port's packed
    PackedAttentionFunction against JAX's einsum path)."""
    jcfg, tcfg = _cfgs(num_hidden_layers=2)
    jm = JCls(jcfg, num_labels=LABELS)
    params = jm.init({"params": jax.random.PRNGKey(9)}, jnp.asarray(_pixels()))
    params = _live_norms(params)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, x: x * blow_up if any("qkv_kernel" in str(k) for k in kp) else x,
        params)
    model = TCls(tcfg, LABELS)
    model.load_state_dict(classifier_params_from_jax(params, tcfg), strict=True)
    rng = np.random.default_rng(10)
    pix = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    labels = rng.integers(0, LABELS, 2)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(pix))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = model(torch.from_numpy(pix))
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=0,
                               atol=1e-4 * max(1.0, np.abs(_f32(jlogits)).max()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    want = classifier_params_from_jax(jg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(v.abs().max()) for v in want.values())
    for n in want:
        assert torch.isfinite(got[n]).all(), n
        np.testing.assert_allclose(_f32(got[n]), want[n].numpy(), rtol=0,
                                   atol=1e-3 * gmax, err_msg=n)


def test_quantize_refuses_qk_norm_trunk():
    """The int8 apply loops run no q/k norm: the quantizer refuses, as the
    JAX package's does."""
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="qk_norm"):
        tqz.quantize_vit_params(TViT(tcfg))
