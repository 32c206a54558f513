"""PyTorch port, mixture of experts and head pruning (CPU) against the JAX
package: `MoEFFN` (dense and dispatch, the overflow drops, the aux loss,
gradients vs `jax.grad`, the bf16 policy), the MoE trunk with its per-layer
aux losses, the int8 quantizer's refusal; `prune_heads` and
`prune_heads_masked` against JAX's through the converter and against
`transformers.ViTModel.prune_heads`, and the int8 apply of a pruned trunk
(3 H' dh != 3 D).  Weights are drawn into `jax.eval_shape` trees from a
numpy seed (no init compiles); the router's with a std of 0.5, so that
no two router logits of a token tie within f32 rounding."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu import compat as jcompat
from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.models.base import pruning as jpr
from msvit_tpu.models.base.moe import MoEFFN as JMoE
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import import_vit_params, vit_params_from_jax
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base import pruning as tpr
from msvit_tpu_torch.models.base import quantized as tqz
from msvit_tpu_torch.models.base.moe import MoEFFN as TMoE
from msvit_tpu_torch.settings import Policy
from msvit_tpu_torch.settings import parity_policy as t_parity

MOE = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_experts=4,
           attn_implementation="xla")
F32_TOL = 1e-5  # MoEFFN output, f32
AUX_TOL = 1e-6  # the Switch loss, f32
GRAD_TOL = 1e-4  # every gradient, f32
TRUNK_TOL = 1e-3  # the repo's parity bar for a whole trunk
BF16_ULPS = 1.0  # bf16 policy: bf16 ulps (2^-7 relative) of the largest output


def random_tree(shapes, seed):
    """Norm scales and layer scales 1, router kernels N(0, 0.5^2), the rest
    N(0, 0.02^2) (biases too)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] in ("scale", "layer_scale1", "layer_scale2"):
            return np.ones(x.shape, x.dtype)
        std = 0.5 if "router" in names and names[-1] == "kernel" else 0.02
        return (std * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _cfgs(**kw):
    kw = {**MOE, **kw}
    return JCfg(policy=j_parity(), **kw), TCfg(policy=t_parity(), **kw)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_state(p):
    return {"router.weight": torch.from_numpy(np.asarray(p["router"]["kernel"]).T.copy()),
            "router.bias": torch.from_numpy(np.array(p["router"]["bias"])),
            **{k: torch.from_numpy(np.array(p[k])) for k in
               ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias")}}


def _moe_pair(jcfg, tcfg, x, seed=1):
    jm = JMoE(jcfg, num_experts=jcfg.num_experts)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_tree(shapes, seed)
    tm = TMoE(tcfg, tcfg.num_experts, torch.Generator().manual_seed(0))
    tm.load_state_dict(_moe_state(params["params"]), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("impl,cf", [("dense", 1.25), ("dispatch", 1.25), ("dispatch", 4.0)])
def test_moe_ffn_matches_jax(impl, cf):
    """Output (f32, 1e-5) and aux loss (1e-6); dispatch at capacity 4 of 10
    tokens drops some tokens, at capacity factor E none."""
    jcfg, tcfg = _cfgs(moe_impl=impl, moe_capacity_factor=cf)
    x = _x((3, 10, 32))
    jm, params, tm = _moe_pair(jcfg, tcfg, x)
    want, want_aux = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
    if impl == "dispatch" and cf == 1.25:
        _, _, slot = tm.route(torch.from_numpy(x))
        assert (slot >= tm.capacity(10)).any()  # the case drops tokens


def test_dispatch_overflow_drops_the_same_tokens():
    """Capacity 1 (factor 0.25, 8 tokens, 2 experts): the tokens past
    their queue's first slot have zero output in both packages, and they
    are the same tokens."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=0.25, num_experts=2)
    x = _x((2, 8, 32), seed=3)
    jm, params, tm = _moe_pair(jcfg, tcfg, x)
    assert tm.capacity(8) == 1
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x))[0])
    got = tm(torch.from_numpy(x))[0].detach().numpy()
    dropped_j = np.all(want == 0, axis=-1)
    dropped_t = np.all(got == 0, axis=-1)
    np.testing.assert_array_equal(dropped_t, dropped_j)
    assert dropped_t.sum() == 2 * 8 - 2 * 2  # two kept per image (one per expert)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_dispatch_equals_dense_without_drops():
    """Capacity factor E: the dispatched output is the dense one."""
    _, tcfg = _cfgs(moe_capacity_factor=4.0)
    x = torch.from_numpy(_x((2, 9, 32), seed=5))
    moe = TMoE(tcfg, 4, torch.Generator().manual_seed(2))
    with torch.no_grad():
        moe.router.weight.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(3))
    disp = moe(x)[0]
    moe.config = dataclasses.replace(tcfg, moe_impl="dense")
    torch.testing.assert_close(disp, moe(x)[0], atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_gradients_match_jax(impl):
    """d(sum(out * g) + aux) w.r.t. every parameter and x, against
    `jax.grad` (1e-4)."""
    jcfg, tcfg = _cfgs(moe_impl=impl)
    x = _x((2, 10, 32), seed=7)
    g = _x((2, 10, 32), seed=8)
    jm, params, tm = _moe_pair(jcfg, tcfg, x)

    def jloss(p, xx):
        out, aux = jm.apply(p, xx)
        return jnp.sum(out * g) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tm(xt)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=GRAD_TOL, rtol=0)
    want = _moe_state(jg_p["params"])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_bf16_policy_matches_jax(impl):
    """bf16 compute, f32 params and router: against JAX within one bf16 ulp
    of the largest output (the expert GEMMs and the GELU round to bf16 in
    both packages, not at the same points); the aux loss (f32 router)
    within 1e-6."""
    kw = {**MOE, "moe_impl": impl}
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    x = _x((2, 10, 32), seed=9)
    jm, params, tm = _moe_pair(jcfg, tcfg, x)
    want, want_aux = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tol = BF16_ULPS * 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=tol, rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


@functools.lru_cache(maxsize=None)
def _moe_trunk():
    jcfg, tcfg = _cfgs(image_size=32, patch_size=8)
    pix = _x((2, 32, 32, 3), seed=11)
    shapes = jax.eval_shape(JViT(jcfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(pix))
    params = random_tree(shapes, 12)
    return jcfg, tcfg, pix, params


def test_moe_trunk_matches_jax():
    """The MoE ViT (two MoE layers, dispatch) against JAX: features within
    the parity bar, each layer's sown aux loss within 1e-6."""
    jcfg, tcfg, pix, params = _moe_trunk()
    (want, state) = jax.jit(functools.partial(JViT(jcfg).apply, mutable=["intermediates"]))(
        params, jnp.asarray(pix))
    model = TViT(tcfg).eval()
    model.load_state_dict(vit_params_from_jax(params, tcfg), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(pix))
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["last_hidden_state"]), atol=TRUNK_TOL, rtol=0)
    inter = state["intermediates"]["encoder"]
    want_aux = [float(inter[f"layer_{i}"]["moe_aux_loss"][0]) for i in range(2)]
    assert len(got["moe_aux_loss"]) == 2
    for g, w in zip(got["moe_aux_loss"], want_aux):
        assert abs(float(g) - w) <= AUX_TOL


def test_moe_trunk_aux_loss_under_remat():
    """Under remat the per-layer aux losses leave the recomputed blocks as
    outputs and carry their gradients: the same values and router
    gradients as without remat."""
    _, tcfg, pix, params = _moe_trunk()
    state = vit_params_from_jax(params, tcfg)
    grads = []
    for remat in (False, True):
        model = TViT(dataclasses.replace(tcfg, remat=remat))
        model.load_state_dict(state)
        aux = model(torch.from_numpy(pix))["moe_aux_loss"]
        sum(aux).backward()
        grads.append([float(a) for a in aux]
                     + model.encoder.layer[1].mlp.router.weight.grad.flatten().tolist())
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-7, rtol=0)


def test_quantizer_refuses_moe_trunk():
    _, tcfg, _, params = _moe_trunk()
    model = TViT(tcfg)
    with pytest.raises(ValueError, match="num_experts"):
        tqz.quantize_vit_params(model)


# ------------------------------------------------------------ pruning


def _hf_pair(hidden=64, layers=3, heads=4, image=32, patch=16):
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(7)
    hf = ViTModel(ViTConfig(hidden_size=hidden, num_hidden_layers=layers,
                            num_attention_heads=heads, intermediate_size=hidden * 4,
                            image_size=image, patch_size=patch, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0, layer_norm_eps=1e-6,
                            attn_implementation="eager"), add_pooling_layer=False).eval()
    kw = dict(hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
              image_size=image, patch_size=patch)
    jcfg, tcfg = JCfg(policy=j_parity(), **kw), TCfg(policy=t_parity(), **kw)
    sd = hf.state_dict()
    return hf, jcfg, tcfg, jcompat.import_vit_params(sd, jcfg), import_vit_params(sd, tcfg)


def _forward(cfg, state, pix):
    model = TViT(cfg).eval()
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(pix))["last_hidden_state"].numpy()


def _hf_forward(hf, pix):
    with torch.no_grad():
        return hf(torch.from_numpy(pix.transpose(0, 3, 1, 2))).last_hidden_state.numpy()


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_prune_heads_surgery_matches_jax_and_hf():
    """One head per layer: the state dict equals JAX's surgery through the
    converter (bit for bit), the config keeps dh, and the pruned model
    equals HF's `prune_heads` (f32, parity bar)."""
    hf, jcfg, tcfg, jparams, tstate = _hf_pair()
    heads = {0: [1], 1: [3], 2: [0]}
    jp, jc = jpr.prune_heads(jparams, jcfg, heads)
    got, tc = tpr.prune_heads(tstate, tcfg, heads)
    _same(got, vit_params_from_jax(jp))
    assert (tc.num_attention_heads, tc.head_dim) == (jc.num_attention_heads, jc.head_dim) == (3, 16)
    assert tuple(got["encoder.layer.0.attention.qkv.weight"].shape) == (3 * 48, 64)
    assert tuple(got["encoder.layer.0.attention.output_dense.weight"].shape) == (64, 48)
    assert tuple(tstate["encoder.layer.0.attention.qkv.weight"].shape) == (192, 64)  # untouched
    hf.prune_heads(heads)
    pix = _x((2, 32, 32, 3), seed=1)
    np.testing.assert_allclose(_forward(tc, got, pix), _hf_forward(hf, pix), atol=TRUNK_TOL,
                               rtol=0)


def test_prune_heads_masked_matches_jax_and_hf():
    """Non-uniform head sets, shapes kept: equal to JAX's masked tree (bit
    for bit) and to HF's pruned model; the surgery of the same heads gives
    the same features."""
    hf, jcfg, tcfg, jparams, tstate = _hf_pair()
    heads = {0: [1, 2], 2: [3]}
    got = tpr.prune_heads_masked(tstate, heads, tcfg)
    _same(got, vit_params_from_jax(jpr.prune_heads_masked(jparams, heads)))
    pix = _x((2, 32, 32, 3), seed=2)
    masked = _forward(tcfg, got, pix)
    hf.prune_heads(heads)
    np.testing.assert_allclose(masked, _hf_forward(hf, pix), atol=TRUNK_TOL, rtol=0)
    uniform = {0: [1], 1: [0], 2: [3]}
    s_state, s_cfg = tpr.prune_heads(tstate, tcfg, uniform)
    np.testing.assert_allclose(_forward(tcfg, tpr.prune_heads_masked(tstate, uniform, tcfg), pix),
                               _forward(s_cfg, s_state, pix), atol=1e-5, rtol=0)


def test_prune_heads_refuses_nonuniform_and_nothing_is_identity():
    _, _, tcfg, _, tstate = _hf_pair()
    with pytest.raises(ValueError, match="masked"):
        tpr.prune_heads(tstate, tcfg, {0: [1, 2], 2: [3]})
    with pytest.raises(ValueError, match="out of range"):
        tpr.prune_heads(tstate, tcfg, {0: [4], 1: [0], 2: [0]})
    same_state, same_cfg = tpr.prune_heads(tstate, tcfg, {0: []})
    assert same_state is tstate and same_cfg is tcfg
    out = tpr.prune_heads_masked(tstate, {1: []}, tcfg)
    _same(out, tstate)


def test_prune_heads_finds_a_classifier_trunk():
    """A `ViTForImageClassification` state dict (``vit.encoder.layer.``)."""
    _, _, tcfg, _, tstate = _hf_pair()
    cls_state = {"vit." + k: v for k, v in tstate.items()}
    got, _ = tpr.prune_heads(cls_state, tcfg, {0: [0], 1: [0], 2: [0]})
    assert tuple(got["vit.encoder.layer.2.attention.qkv.weight"].shape) == (144, 64)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_int8_apply_of_a_pruned_trunk(use_kernels):
    """ViT with 4 -> 3 heads (3 H' dh = 144, 3 D = 192) through the int8
    apply, calibrated (K3's plain version on the int8 path with
    `use_kernels`): finite, and within cosine 0.99 of the pruned f32
    model's features."""
    _, _, tcfg, _, tstate = _hf_pair()
    s_state, s_cfg = tpr.prune_heads(tstate, tcfg, {0: [1], 1: [3], 2: [0]})
    s_cfg = dataclasses.replace(s_cfg, policy=Policy())
    model = TViT(s_cfg).eval()
    model.load_state_dict(s_state)
    pix = torch.from_numpy(_x((4, 32, 32, 3), seed=3))
    qparams = tqz.quantize_vit_params(model)
    scales = tqz.calibrate_act_scales(qparams, s_cfg, pix, use_kernels=use_kernels)
    assert tuple(scales["attn_0"].shape) == (3,)
    got = tqz.quantized_vit_apply(qparams, s_cfg, pix, act_scales=scales,
                                  use_kernels=use_kernels).float()
    want = torch.from_numpy(_forward(dataclasses.replace(s_cfg, policy=t_parity()), s_state,
                                     pix.numpy()))
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1), dim=1)
    assert cos.min() > 0.99, cos
