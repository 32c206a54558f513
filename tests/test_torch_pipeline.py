"""GPipe of the port (`msvit_tpu_torch/parallel/pipeline.py`,
`pipeline_vit.py`) on 4 gloo CPU ranks ("stage" axis of 4) against the JAX
package's sequential models on the same converted weights: counterparts of
`tests/test_pipeline.py` (the encoder's forward and gradients, the whole
classifier's forward, masked, and one `Trainer` AdamW step).

8 layers in 4 stages of 2, 4 microbatches of 2.  Bars: port against JAX
1e-4 (JAX's pipelined-vs-sequential bar for gradients; the repo's f32 bar
is 1e-3), pipelined against unsharded port 1e-5; the AdamW step as below.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import ViTModel as JViT
from msvit_tpu.models.base.model import BaseViTEncoder as JEncoder
from msvit_tpu.models.base.vit import ViTForImageClassification as JClassifier
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import classifier_params_from_jax
from msvit_tpu_torch.compat.from_jax import _layer
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTForImageClassification as TClassifier
from msvit_tpu_torch.parallel import launch
from msvit_tpu_torch.parallel.pipeline import split_layers_into_stages
from msvit_tpu_torch.parallel.pipeline_vit import PipelinedViTClassifier, pipeline_params_from_full
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import Trainer, make_optimizer

BODIES = "torch_parallel_bodies"
ENC = dict(hidden_size=32, num_hidden_layers=8, num_attention_heads=4)
FULL = dict(ENC, image_size=16, patch_size=8)
LR = 1e-3


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, timeout=60, preload=(BODIES,)) as p:
        yield p


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_tree(shapes, seed):
    """Values for the tree of `jax.eval_shape(init)` (a trace, no compile;
    `tests/test_torch_subsample.py::random_tree`): LayerNorm scales and
    LayerScale 1, the rest N(0, 0.02^2), biases too."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "layer_scale1", "layer_scale2"):
            return np.ones(x.shape, x.dtype)
        return (0.02 * rng.standard_normal(x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _init(module, seed, *args):
    return random_tree(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args), seed)


@functools.lru_cache(maxsize=None)
def _encoder():
    enc = JEncoder(JCfg(policy=j_parity(), attn_implementation="xla", **ENC))
    x = np.random.default_rng(0).standard_normal((8, 12, 32)).astype(np.float32)
    params = _init(enc, 1, jnp.asarray(x))["params"]
    state = {}
    for name, p in _np_tree(params).items():
        _layer(state, "layer." + name.split("_")[1], p)
    return enc, params, x, {k: v.numpy() for k, v in state.items()}


def test_gpipe_forward_matches_sequential(pool):
    enc, params, x, state = _encoder()
    want = np.asarray(jax.jit(enc.apply)({"params": params}, jnp.asarray(x))[0])
    for r in pool.run(f"{BODIES}:gpipe_encoder", cfg=ENC, state=state, x=x):
        np.testing.assert_allclose(r["out"], want, atol=1e-5)


def test_gpipe_grads_match_sequential(pool):
    """Each stage's layers' gradients of sum(out^2) against jax.grad of the
    sequential encoder; together they are every layer's."""
    enc, params, x, state = _encoder()
    g = jax.jit(jax.grad(lambda p: jnp.sum(enc.apply({"params": p}, jnp.asarray(x))[0] ** 2)))(
        params)
    want = {}
    for name, p in _np_tree(g).items():
        _layer(want, "layer." + name.split("_")[1], p)
    got = {}
    for r in pool.run(f"{BODIES}:gpipe_encoder", cfg=ENC, state=state, x=x, grads=True):
        got.update(r["grads"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-4, err_msg=k)


_FULL = {}


def _full():
    if not _FULL:
        model = JClassifier(JCfg(policy=j_parity(), attn_implementation="xla", **FULL), 10)
        pix = np.random.default_rng(0).standard_normal((8, 16, 16, 3)).astype(np.float32)
        params = _init(model, 1, jnp.asarray(pix[:1]))
        _FULL.update(model=model, params=params, pix=pix,
                     state={k: v.numpy() for k, v in
                            classifier_params_from_jax(_np_tree(params)).items()})
    return _FULL


def test_full_model_pipeline_forward_matches_sequential(pool):
    c = _full()
    want = np.asarray(jax.jit(c["model"].apply)(c["params"], jnp.asarray(c["pix"])))
    for r in pool.run(f"{BODIES}:pipelined_classifier", cfg=FULL, state=c["state"],
                      pixels=c["pix"]):
        np.testing.assert_allclose(r["logits"], want, atol=1e-4)


def test_full_model_pipeline_forward_with_mask(pool):
    """An attention mask [B, 1, N, N] travels per microbatch: the logits
    equal JAX's ViTModel with the mask, through its LayerNorm and head, and
    differ from the unmasked ones."""
    c = _full()
    n = 5
    mask = np.random.default_rng(3).random((8, 1, n, n)) < 0.8
    mask |= np.eye(n, dtype=bool)[None, None]
    vit = JViT(JCfg(policy=j_parity(), attn_implementation="xla", **FULL))
    seq = jax.jit(vit.apply)({"params": c["params"]["params"]["vit"]}, jnp.asarray(c["pix"]),
                             attention_mask=jnp.asarray(mask))["last_hidden_state"]
    head = c["params"]["params"]["classifier"]
    want = np.asarray(seq[:, 0] @ head["kernel"] + head["bias"])
    out = pool.run(f"{BODIES}:pipelined_classifier", cfg=FULL, state=c["state"],
                   pixels=c["pix"], mask=mask)
    for r in out:
        np.testing.assert_allclose(r["logits"], want, atol=1e-4)
    unmasked = np.asarray(jax.jit(c["model"].apply)(c["params"], jnp.asarray(c["pix"])))
    assert not np.allclose(out[0]["logits"], unmasked)


def test_full_model_pipelined_training_step_matches_sequential(pool):
    """One `Trainer` AdamW step on the pipelined model against the same
    step on the sequential port and optax.adamw on JAX's model.  From equal
    weights the update ~lr sign(g) is exact where |g| >= 1e-4 (held to
    1e-5); where the gradient is f32 dust, AdamW turns the dust in which
    the reductions differ into up to 2 lr (that bar)."""
    c = _full()
    labels = np.arange(8) % 10
    out = pool.run(f"{BODIES}:pipelined_classifier", cfg=FULL, state=c["state"],
                   pixels=c["pix"], labels=labels, lr=LR)
    seq = TClassifier(TCfg(policy=t_parity(), **FULL), 10)
    seq.load_state_dict({k: torch.from_numpy(v) for k, v in c["state"].items()})
    x, y = torch.from_numpy(c["pix"]), torch.from_numpy(labels).long()

    def loss_fn(m, b, g):
        return F.cross_entropy(m(b["pixel_values"]), b["labels"]), {}

    trainer = Trainer(loss_fn, make_optimizer(LR, weight_decay=1e-4), seq, log_every=1)
    trainer.fit([{"pixel_values": x, "labels": y}], num_steps=1, seed=0)
    grads = {k: p.grad.numpy() for k, p in seq.named_parameters()}
    opt = optax.adamw(LR)  # weight decay 1e-4, as the port's step here
    jmodel = c["model"]

    def jloss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jmodel.apply(p, jnp.asarray(c["pix"])), jnp.asarray(labels)).mean()

    loss, g = jax.jit(jax.value_and_grad(jloss))(c["params"])
    upd, _ = opt.update(g, opt.init(c["params"]), c["params"])
    jparams = classifier_params_from_jax(_np_tree(optax.apply_updates(c["params"], upd)))
    for stage, r in enumerate(out):
        assert abs(r["loss"] - float(loss)) <= 1e-5
        for ref in (seq.state_dict(), jparams):
            want = pipeline_params_from_full(ref, 4, stage)
            live = pipeline_params_from_full({k: torch.from_numpy(v) for k, v in grads.items()},
                                             4, stage)
            for k, w in want.items():
                d = np.abs(r["state"][k] - w.numpy())
                assert d.max() <= 2 * LR, (k, d.max())
                assert d[np.abs(live[k].numpy()) >= 1e-4].max(initial=0.0) <= 1e-5, k


def test_split_layers_and_stage_params():
    """`split_layers_into_stages` and `pipeline_params_from_full` cut the
    sequential state into the stages' `PipelinedViTClassifier`s, which load
    it strictly."""
    full = TClassifier(TCfg(**FULL), 10).state_dict()
    enc = {k[len("vit.encoder."):]: v for k, v in full.items() if k.startswith("vit.encoder.")}
    stages = split_layers_into_stages(enc, 4)
    assert torch.equal(stages[3]["1.mlp.fc1.weight"], enc["layer.7.mlp.fc1.weight"])
    for s in range(4):
        PipelinedViTClassifier(TCfg(**FULL), 10, 4).load_state_dict(
            pipeline_params_from_full(full, 4, s), strict=True)
    with pytest.raises(ValueError, match="divisible"):
        split_layers_into_stages(enc, 3)
