"""PyTorch port, position-table resampling against the JAX package (CPU):
`interpolate_pos_embed` against `jax.image.resize(..., "bicubic")` (the
Keys cubic with a = -0.5, half-pixel centres, normalised weights and an
antialiasing kernel when shrinking, which `F.interpolate` is not), and the
paths that take it at a patch grid other than the config's: `ViTModel`,
the int8 `quantized_vit_apply`, `quantized_multistate_apply` and
`transfer_base_to_multistate`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.compat.family_import import transfer_base_to_multistate as j_transfer
from msvit_tpu.models import multistate as jms
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.models.base import quantized as jqz
from msvit_tpu.models.base.vit import interpolate_pos_embed as j_interp
from msvit_tpu.models.base.vit import ViTForImageClassification as JCls
from msvit_tpu.models.clustering import SpectralClusteringConfig as JSpectral
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import (
    act_scales_from_jax, multistate_params_from_jax, vit_params_from_jax)
from msvit_tpu_torch.compat.family import transfer_base_to_multistate
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base import quantized as tqz
from msvit_tpu_torch.models.base.vit import interpolate_pos_embed, resize_weights
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig as TSpectral
from msvit_tpu_torch.settings import parity_policy as t_parity
from test_torch_clustering import JaxRng

# a 3 x 3 grid at the config's 48 px
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             image_size=48, patch_size=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cos(a, b):
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _pixels(h, w, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, h, w, 3)).astype(np.float32)


# ------------------------------------------------------------ resampler ----


@pytest.mark.parametrize("has_cls", [True, False])
@pytest.mark.parametrize("old,grid", [(4, (6, 6)), (7, (14, 14)), (14, (7, 7)),
                                      (6, (4, 4)), (4, (3, 5))],
                         ids=["grow4-6", "grow7-14", "shrink14-7", "shrink6-4",
                              "nonsquare4-3x5"])
def test_interpolate_pos_embed_matches_jax(old, grid, has_cls):
    """The resampled table equals JAX's within 1e-5 (f32): growing,
    shrinking (the antialiasing kernel) and a non-square grid; the CLS row
    is carried over unchanged."""
    rng = np.random.default_rng(old * 10 + grid[1])
    pe = rng.standard_normal((1, old * old + has_cls, 24)).astype(np.float32)
    n = grid[0] * grid[1]
    want = np.asarray(j_interp(jnp.asarray(pe), n, grid, has_cls=has_cls))
    got = interpolate_pos_embed(torch.from_numpy(pe), n, grid, has_cls=has_cls)
    assert got.shape == want.shape == (1, n + has_cls, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if has_cls:
        np.testing.assert_array_equal(got[:, 0].numpy(), pe[:, 0])


def test_resize_weights_are_not_torch_bicubic():
    """Why the port builds its own resampler: each output's weights sum to
    1, and they differ from `F.interpolate(mode="bicubic")`'s (a = -0.75,
    no antialias) where the grid grows and where it shrinks."""
    for n_in, n_out in ((4, 6), (14, 7)):
        w = resize_weights(n_in, n_out)
        torch.testing.assert_close(w.sum(0), torch.ones(n_out), rtol=0, atol=1e-6)
        eye = torch.eye(n_in)[None, None]  # row i: the unit impulse at i
        torch_w = torch.nn.functional.interpolate(
            eye, size=(n_in, n_out), mode="bicubic", align_corners=False)[0, 0]
        assert (torch_w - w).abs().max() > 1e-2


def test_identity_grid_returns_the_table():
    pe = torch.randn(1, 10, 8)
    assert interpolate_pos_embed(pe, 9, (3, 3)) is pe


# ------------------------------------------------------- model paths ----


def _vit_pair():
    jcfg, tcfg = JCfg(policy=j_parity(), **SMALL), TCfg(policy=t_parity(), **SMALL)
    params = jax.jit(JViT(jcfg).init)({"params": jax.random.PRNGKey(0)},
                                      jnp.zeros((1, 48, 48, 3)))
    model = TViT(tcfg)
    model.load_state_dict(vit_params_from_jax(params, tcfg), strict=True)
    return jcfg, tcfg, params, model.eval()


@pytest.mark.parametrize("hw", [(64, 64), (32, 32), (80, 48)],
                         ids=["grow", "shrink", "nonsquare"])
def test_vit_at_a_non_native_grid_matches_jax(hw):
    """`ViTModel` of a 48-px config (3 x 3 table) at 64 px (4 x 4), 32 px
    (2 x 2) and 80 x 48 px (5 x 3): last_hidden_state within the parity
    bar, 1e-3 (f32)."""
    jcfg, _, params, model = _vit_pair()
    pix = _pixels(*hw, seed=hw[0])
    want = jax.jit(JViT(jcfg).apply)(params, jnp.asarray(pix))["last_hidden_state"]
    with torch.inference_mode():
        got = model(torch.from_numpy(pix))["last_hidden_state"]
    assert got.shape == want.shape == (2, 1 + (hw[0] // 16) * (hw[1] // 16), 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=0)


def test_channels_first_input_still_raises():
    _, _, _, model = _vit_pair()
    with pytest.raises(ValueError, match="channels-first"):
        model(torch.zeros(1, 3, 64, 64))


@pytest.mark.parametrize("hw", [(64, 64), (32, 32)], ids=["grow", "shrink"])
def test_quantized_vit_at_a_non_native_grid_matches_jax(hw):
    """The int8 apply (kernels on, calibrated scales) at another grid: the
    int8 bar of tests/test_torch_vit.py, cosine >= 0.999."""
    jcfg, tcfg, params, model = _vit_pair()
    jq, tq = jqz.quantize_vit_params(params["params"]), tqz.quantize_vit_params(model)
    pix = _pixels(*hw, seed=5)
    js = jax.jit(lambda q, p: jqz.calibrate_act_scales(q, jcfg, p, use_kernels=False))(
        jq, jnp.asarray(pix))
    want = jax.jit(lambda q, p, s: jqz.quantized_vit_apply(
        q, jcfg, p, act_scales=s, use_kernels=True))(jq, jnp.asarray(pix), js)
    got = tqz.quantized_vit_apply(tq, tcfg, torch.from_numpy(pix),
                                  act_scales=act_scales_from_jax(js), use_kernels=True)
    assert got.shape == want.shape
    assert _cos(got, want) >= 0.999


def _ms_cfgs(**kw):
    clus = dict(ncut_dim=4, num_sample=16, max_clusters=4)
    base = dict(hidden_size=64, num_attention_heads=4, num_hidden_layers=2,
                image_size=64, patch_size=16, attn_implementation="xla",
                pregeneration_period=1, generation_period=1, **kw)
    return (jms.MultiStateViTConfig(policy=j_parity(), clustering=JSpectral(**clus), **base),
            tms.MultiStateViTConfig(policy=t_parity(), clustering=TSpectral(**clus), **base))


def test_quantized_multistate_at_a_non_native_grid_matches_jax():
    """`quantized_multistate_apply` of a 64-px config (4 x 4 table) at 80 px
    (5 x 5) with `interpolate_pos_encoding=True` and a clustering event:
    the partition equals JAX's, hidden states and TX tokens at cosine
    >= 0.999 (the int8 bar)."""
    jcfg, tcfg = _ms_cfgs()
    key = jax.random.PRNGKey(3)
    # initialised without clustering events (the same params, a cheaper init)
    variables = jax.jit(jms.MultiStateViTEncoderModel(
        dataclasses.replace(jcfg, pregeneration_period=99)).init)(
            {"params": key, "clustering": key}, jnp.zeros((1, 64, 64, 3)))
    tmodel = tms.MultiStateViTEncoderModel(tcfg)
    tmodel.load_state_dict(multistate_params_from_jax(variables, tcfg), strict=True)
    jq = jms.quantize_multistate_params(variables["params"])
    tq = tms.quantize_multistate_params(tmodel)
    rng = np.random.default_rng(4)  # 25 patches copied from 3 prototypes
    protos = rng.standard_normal((3, 16, 16, 3)) * 3.0
    pix = protos[rng.integers(0, 3, (2, 5, 5))] + 0.1 * rng.standard_normal((2, 5, 5, 16, 16, 3))
    pix = pix.transpose(0, 1, 3, 2, 4, 5).reshape(2, 80, 80, 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    # jitted: JAX's eager clustering costs seconds per call
    js = jax.jit(lambda q, p, k: jms.calibrate_multistate_act_scales(
        q, jcfg, p, k, use_kernels=False))(jq, jnp.asarray(pix), key)
    want = jax.jit(lambda q, p, k, s: jms.quantized_multistate_apply(
        q, jcfg, p, k, act_scales=s, use_kernels=True, interpolate_pos_encoding=True))(
            jq, jnp.asarray(pix), key, js)
    got = tms.quantized_multistate_apply(tq, tcfg, torch.from_numpy(pix), JaxRng(key),
                                         act_scales=act_scales_from_jax(js), use_kernels=True,
                                         interpolate_pos_encoding=True)
    assert got["last_hidden_state"].shape[1] == want["last_hidden_state"].shape[1] == 25
    assert int(np.max(np.asarray(want["num_clusters"]))) >= 2  # a live split
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    assert _cos(got["last_hidden_state"], want["last_hidden_state"]) >= 0.999
    assert _cos(got["cluster_tokens"], want["cluster_tokens"]) >= 0.999


@pytest.mark.parametrize("image", [32, 96], ids=["shrink", "grow"])
def test_transfer_resamples_a_table_of_another_length(image):
    """`transfer_base_to_multistate` from a 48-px classifier (3 x 3 table)
    into a multistate model of 32 px (2 x 2) or 96 px (6 x 6): the table
    equals JAX's transfer within 1e-5 (f32), every other tensor exactly."""
    pix = jnp.zeros((1, 48, 48, 3))
    base = jax.jit(JCls(JCfg(**SMALL), num_labels=5).init)(
        {"params": jax.random.PRNGKey(0)}, pix)["params"]["vit"]
    geom = {**SMALL, "image_size": image}
    ms = jax.jit(jms.MultiStateViTEncoderModel(jms.MultiStateViTConfig(
        pregeneration_period=99,
        clustering=JSpectral(ncut_dim=4, num_sample=8, max_clusters=4), **geom)).init)(
            {"params": jax.random.PRNGKey(1), "clustering": jax.random.PRNGKey(1)},
            jnp.zeros((1, image, image, 3)))["params"]
    want = multistate_params_from_jax(j_transfer(base, ms, 2))
    got = transfer_base_to_multistate(vit_params_from_jax(base),
                                      multistate_params_from_jax(ms), 2)
    assert set(got) == set(want)
    table = "embeddings.position_embeddings"
    assert got[table].shape == (1, (image // 16) ** 2, 64)
    torch.testing.assert_close(got[table], want[table], rtol=0, atol=1e-5)
    for k in want:
        if k != table:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
