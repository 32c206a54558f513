"""PyTorch port, HF checkpoint import (CPU): `import_vit_params` against
the JAX package's through `vit_params_from_jax` (bit for bit), the port's
ViT against `transformers` (f32, 1e-3), the pretrained workflow from a
directory on disk, the three family bootstraps against JAX's (bit for bit,
through the converters), `resolve_checkpoint` and `config_from_hf`, and the
model zoo.  HF models are built locally with random weights: nothing is
downloaded, and the hub is never asked (`_network_available` is patched
to False where a hub id is resolved)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu import compat as jcompat
from msvit_tpu import zoo as jzoo
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch import zoo as tzoo
from msvit_tpu_torch.compat import (
    config_from_hf,
    import_into_multistate,
    import_into_predictive,
    import_into_subsample,
    import_vit_params,
    load_pretrained_vit,
    load_state_dict_from,
    multistate_params_from_jax,
    predictive_params_from_jax,
    resolve_checkpoint,
    subsample_classifier_params_from_jax,
    vit_params_from_jax,
)
from msvit_tpu_torch.compat import pretrained as tpretrained
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base.vit import interpolate_pos_embed
from msvit_tpu_torch.settings import parity_policy as t_parity

HF_TOL = 1e-3  # the repo's f32 parity bar against transformers

SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4)


def hf_vit(hidden=64, layers=3, heads=4, image=32, patch=8, seed=7):
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(seed)
    cfg = ViTConfig(hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
                    intermediate_size=hidden * 4, image_size=image, patch_size=patch,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                    layer_norm_eps=1e-6, attn_implementation="eager")
    return ViTModel(cfg, add_pooling_layer=True).eval()


def hf_dinov2(swiglu=False, seed=3):
    """A random Dinov2Model (28 px, patch 14: 4 patches) whose layer scales
    and biases are drawn too, so that they are exercised."""
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    cfg = Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                       mlp_ratio=4, image_size=28, patch_size=14, layerscale_value=1e-5,
                       use_swiglu_ffn=swiglu, attn_implementation="eager")
    model = Dinov2Model(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lambda1"):
                p.copy_(torch.rand(p.shape) * 0.5 + 0.5)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.02)
    return model, cfg


def _hf_out(model, pix):
    with torch.no_grad():
        return model(torch.from_numpy(pix.transpose(0, 3, 1, 2))).last_hidden_state.numpy()


def _port_out(cfg, state, pix, add_pooler=False):
    model = TViT(cfg, add_pooler=add_pooler).eval()
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(pix))["last_hidden_state"].float().numpy()


def _pix(size, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _dino_kw(swiglu):
    return dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=4.0,
                image_size=28, patch_size=14, layerscale_value=1e-5, use_swiglu_ffn=swiglu)


@pytest.mark.parametrize("kind", ["vit", "dinov2", "swiglu"])
@pytest.mark.parametrize("add_cls_token", [True, False])
def test_import_matches_jax_bit_for_bit(kind, add_cls_token):
    """Key for key and bit for bit: the port's state dict equals the JAX
    import's tree through the converter (pooler included for HF ViT)."""
    if kind == "vit":
        hf = hf_vit()
        kw = dict(SMALL, image_size=32, patch_size=8)
    else:
        hf, _ = hf_dinov2(swiglu=kind == "swiglu")
        kw = _dino_kw(kind == "swiglu")
    sd = hf.state_dict()
    want = vit_params_from_jax(jcompat.import_vit_params(
        sd, JCfg(**kw), add_cls_token=add_cls_token, add_pooler=True))
    got = import_vit_params(sd, TCfg(**kw), add_cls_token=add_cls_token, add_pooler=True)
    _assert_same_state(got, want)
    if kind != "vit":  # the checkpoint's layer scales, not the config's value
        assert torch.equal(got["encoder.layer.1.layer_scale2"],
                           sd["encoder.layer.1.layer_scale2.lambda1"])


def test_import_layout():
    """q|k|v rows of the fused weight and the (p1, p2, c) patch features."""
    hf = hf_vit()
    sd = hf.state_dict()
    got = import_vit_params(sd, TCfg(**SMALL, image_size=32, patch_size=8))
    qkv = got["encoder.layer.2.attention.qkv.weight"]
    key = sd["encoder.layer.2.attention.attention.key.weight"]
    assert torch.equal(qkv[64 + 16 * 3 + 5], key[16 * 3 + 5])
    conv = sd["embeddings.patch_embeddings.projection.weight"]  # [D, C, P, P]
    p1, p2, c = 3, 6, 2
    assert torch.equal(got["embeddings.patch_projection.weight"][:, (p1 * 8 + p2) * 3 + c],
                       conv[:, c, p1, p2])


@pytest.mark.parametrize("hidden,layers,heads,image,patch",
                         [(64, 3, 4, 32, 16), (768, 12, 12, 224, 16)])
def test_port_matches_hf_vit(hidden, layers, heads, image, patch):
    """The imported model against HF's `last_hidden_state` in f32, at a
    small width and at ViT-B/16 @224 (<= 1e-3)."""
    hf = hf_vit(hidden, layers, heads, image, patch, seed=1212)
    cfg = TCfg(hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
               image_size=image, patch_size=patch, policy=t_parity())
    pix = _pix(image)
    got = _port_out(cfg, import_vit_params(hf.state_dict(), cfg), pix)
    np.testing.assert_allclose(got, _hf_out(hf, pix), atol=HF_TOL, rtol=0)


@pytest.mark.parametrize("swiglu", [False, True])
def test_port_matches_hf_dinov2(swiglu):
    """Dinov2Model (layer scale, and the SwiGLU FFN) through `config_from_hf`
    and the import, against HF in f32 (<= 1e-3)."""
    hf, hf_cfg = hf_dinov2(swiglu)
    cfg = config_from_hf({**hf_cfg.to_dict(), "model_type": "dinov2"}, policy=t_parity())
    assert cfg.use_swiglu_ffn == swiglu and cfg.layerscale_value == 1e-5
    pix = _pix(28, seed=4)
    got = _port_out(cfg, import_vit_params(hf.state_dict(), cfg), pix)
    np.testing.assert_allclose(got, _hf_out(hf, pix), atol=HF_TOL, rtol=0)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_pretrained_vit_from_disk(tmp_path, fmt):
    """`save_pretrained` (model.safetensors) or `torch.save`
    (pytorch_model.bin, the card machine's route) beside config.json: the
    config from config.json, the pooler kept, features against HF."""
    hf = hf_vit()
    if fmt == "safetensors":
        hf.save_pretrained(str(tmp_path))
    else:
        torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
        with open(tmp_path / "config.json", "w") as f:
            json.dump({**hf.config.to_dict(), "model_type": "vit"}, f)
    path, _ = resolve_checkpoint(str(tmp_path))
    assert path.endswith("model.safetensors" if fmt == "safetensors" else "pytorch_model.bin")
    cfg, state = load_pretrained_vit(str(tmp_path), add_pooler=True, policy=t_parity())
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.patch_size) == (64, 3, 8)
    assert abs(cfg.mlp_ratio - 4.0) < 1e-9 and "pooler_dense.weight" in state
    pix = _pix(32, seed=2)
    got = _port_out(cfg, state, pix, add_pooler=True)
    np.testing.assert_allclose(got, _hf_out(hf, pix), atol=HF_TOL, rtol=0)
    # a given config with overrides, from the weights file itself
    cfg2, state2 = load_pretrained_vit(path, TCfg(**SMALL, image_size=32, patch_size=8),
                                       policy=t_parity())
    assert cfg2.policy == t_parity()
    _assert_same_state(state2, {k: v for k, v in state.items() if not k.startswith("pooler")})


def test_resolve_checkpoint_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(tpretrained, "_network_available", lambda *a: False)
    with pytest.raises(FileNotFoundError, match="unreachable"):
        load_state_dict_from("facebook/does-not-exist-anywhere")
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        resolve_checkpoint(str(tmp_path))
    torch.save(hf_vit().state_dict(), tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError, match="config.json"):
        load_pretrained_vit(str(tmp_path))


def test_load_torch_state_dict_names_a_missing_package(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_safetensors(name, *a, **k):
        if name.startswith("safetensors"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    from msvit_tpu_torch.compat import load_torch_state_dict

    with pytest.raises(ImportError, match="'safetensors' package"):
        load_torch_state_dict(str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("hf", [
    {"model_type": "dinov2", "hidden_size": 96, "num_hidden_layers": 2,
     "num_attention_heads": 4, "image_size": 28, "patch_size": 14, "mlp_ratio": 4,
     "use_swiglu_ffn": True, "layerscale_value": 1e-5, "qkv_bias": True},
    {"model_type": "vit", "hidden_size": 64, "intermediate_size": 128, "patch_size": 8},
])
def test_config_from_hf_matches_jax(hf):
    got, want = config_from_hf(hf), jcompat.config_from_hf(hf)
    names = [f.name for f in dataclasses.fields(TCfg) if f.name != "policy"]
    assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}


# ------------------------------------------------------------ the families


def random_tree(shapes, seed):
    """Values for a `jax.eval_shape(init)` tree (no compile): norm scales
    and layer scales 1, the rest N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "layer_scale1", "layer_scale2"):
            return np.ones(x.shape, x.dtype)
        return (0.02 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _ms_cfgs(image_size=32):
    from msvit_tpu.models.clustering import SpectralClusteringConfig as JSC
    from msvit_tpu.models.multistate import MultiStateViTConfig as JMS
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig as TSC
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig as TMS

    kw = dict(SMALL, image_size=image_size, patch_size=8, pregeneration_period=2,
              generation_period=1, attn_implementation="xla")
    ck = dict(ncut_dim=4, num_sample=64, max_clusters=8)
    return (JMS(**kw, clustering=JSC(**ck), policy=j_parity()),
            TMS(**kw, clustering=TSC(**ck), policy=t_parity()))


def test_multistate_bootstrap_matches_jax():
    """`import_into_multistate` against JAX's (bit for bit through the
    converter), TX and RX two distinct copies of the CLS token; the
    imported encoder then runs at 64 px, twice its table's grid (the
    table resampled in the forward)."""
    from msvit_tpu.models.multistate import MultiStateViTEncoderModel as JMSM
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel as TMSM
    from msvit_tpu_torch.utils.rng import Rng

    hf = hf_vit()
    sd = hf.state_dict()
    jcfg, tcfg = _ms_cfgs()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(JMSM(jcfg).init, {"params": key, "clustering": key},
                            jnp.zeros((1, 64, 64, 3)))
    tree = random_tree(shapes, 5)["params"]
    want = multistate_params_from_jax(jcompat.import_into_multistate(sd, jcfg, tree))
    got = import_into_multistate(sd, tcfg, multistate_params_from_jax(tree))
    _assert_same_state(got, want)
    tx, rx = got["backbone.transmitter_token"], got["backbone.receiver_token"]
    assert torch.equal(tx, sd["embeddings.cls_token"][0, 0]) and torch.equal(tx, rx)
    assert tx.data_ptr() != rx.data_ptr()

    model = TMSM(tcfg).eval()
    model.load_state_dict(got, strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(_pix(64, seed=3)), rng=Rng(3))
    lh = out["last_hidden_state"]
    assert tuple(lh.shape) == (2, 64, 64) and torch.isfinite(lh).all()


def test_multistate_import_resamples_another_grid():
    """A 4 x 4 checkpoint table into a 64-px encoder (8 x 8 rows): the
    table is `interpolate_pos_embed` of the checkpoint's, CLS row dropped."""
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel as TMSM

    sd = hf_vit().state_dict()
    _, tcfg = _ms_cfgs(image_size=64)
    got = import_into_multistate(sd, tcfg, TMSM(tcfg).state_dict())
    want = interpolate_pos_embed(sd["embeddings.position_embeddings"][:, 1:], 64, (8, 8),
                                 has_cls=False)
    assert torch.equal(got["embeddings.position_embeddings"], want)


def test_predictive_and_subsample_bootstraps_match_jax():
    """`import_into_predictive` (trunk + CLS) and `import_into_subsample`
    (the classifier's ``model.`` tree: trunk, patch projection, table, CLS)
    against JAX's, bit for bit through the converters."""
    from msvit_tpu.models.predictive import PredictiveViTConfig as JPC
    from msvit_tpu.models.predictive import PredictiveViTModel as JPM
    from msvit_tpu.models.subsample import SubsampleViTConfig as JSC
    from msvit_tpu.models.subsample import SubsampleViTForImageClassification as JSM
    from msvit_tpu_torch.models.predictive import PredictiveViTConfig as TPC
    from msvit_tpu_torch.models.subsample import SubsampleViTConfig as TSC

    sd = hf_vit().state_dict()
    key = jax.random.PRNGKey(0)
    pix = jnp.zeros((1, 32, 32, 3))

    pkw = dict(SMALL, image_size=32, patch_size=16, max_context_length=3)
    jp = JPC(**pkw)
    shapes = jax.eval_shape(JPM(jp).init, {"params": key, "glimpse": key}, pix)
    tree = random_tree(shapes, 6)["params"]
    want = predictive_params_from_jax(jcompat.import_into_predictive(sd, jp, tree))
    got = import_into_predictive(sd, TPC(**pkw), predictive_params_from_jax(tree))
    _assert_same_state(got, want)

    skw = dict(SMALL, image_size=32, patch_size=8, initial_grid_size=2, max_depth=1,
               num_labels=5)
    js = JSC(**skw)
    shapes = jax.eval_shape(JSM(js).init, {"params": key, "policy": key}, pix,
                            jnp.zeros((1,), jnp.int32))
    tree = random_tree(shapes, 7)["params"]
    want = subsample_classifier_params_from_jax(jcompat.import_into_subsample(sd, js, tree))
    got = import_into_subsample(sd, TSC(**skw), subsample_classifier_params_from_jax(tree))
    _assert_same_state(got, want)


# ------------------------------------------------------------ the zoo


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "policy"}
    return x


def test_zoo_matches_jax():
    """The same thirteen names, each config field for field (the policies,
    which hold each package's dtypes, left out)."""
    assert tzoo.zoo_names() == jzoo.zoo_names()
    for name in tzoo.zoo_names():
        assert _plain(tzoo.build_config(name)) == _plain(jzoo.build_config(name)), name
    cfg = tzoo.build_config("vit-l16", remat=True)
    assert cfg.remat and cfg.hidden_size == 1024
    assert tzoo.build_config("vit-b16") is not tzoo.build_config("vit-b16")
    with pytest.raises(TypeError):
        tzoo.build_config("vit-b16", no_such_field=1)
    with pytest.raises(KeyError, match="available"):
        tzoo.build_config("vit-zz")
