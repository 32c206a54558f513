"""PyTorch port, multistate fine-tuning against the JAX package (CPU):
`MultiStateViTForImageClassification` (the TX/RX tokens and a classifier
over the occupancy-pooled TX tokens) loss and gradients against
`jax.value_and_grad`, two `Trainer` steps of the TX/RX tokens and the head
against JAX's `Trainer.step_fn`, the example's command line, and seeded
dropout (port against port).

Both packages run `attn_implementation="fused"`: the soft-masked layers
take K5-lse and K6 (JAX: the Pallas kernels in interpret mode; the port:
their plain versions through `FusedAttentionFunction`), the last layer the
plain path.  Clustering draws JAX's numbers (`JaxRng`) on weights carried
by `multistate_classifier_params_from_jax`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import multistate as jms
from msvit_tpu.models.clustering import SpectralClusteringConfig as JSpectral
from msvit_tpu.settings import default_policy as j_default
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu.train.loop import make_optimizer as j_make_optimizer
from msvit_tpu.train.trainer import Trainer as JTrainer
from msvit_tpu_torch.compat import multistate_classifier_params_from_jax
from msvit_tpu_torch.examples import train_multistate as example
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig as TSpectral
from msvit_tpu_torch.ops import fused_attention as tfused
from msvit_tpu_torch.ops.flash_attention import flash_attention_bwd
from msvit_tpu_torch.settings import default_policy as t_default
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import Trainer, make_optimizer
from test_torch_clustering import JaxRng
from test_torch_multistate import _cos, _event_margins, _np, _pixels

LABELS = 5
C = 4  # cluster slots: 64 patch tokens + 2 * 4 = 72 tokens


def _cfgs(policy="parity", shared=True, **kw):
    """hidden 64, 4 heads (dh 16), 4 layers, 64 px at patch 8; clustering
    events at layers 2 and 3 (pooled, rbf, subspace)."""
    clus = dict(ncut_dim=4, num_sample=32, max_clusters=C, eigenvalue_threshold=0.1,
                shared_anchors=shared, anchors_per_parent=16)
    base = dict(hidden_size=64, num_attention_heads=4, num_hidden_layers=4, image_size=64,
                patch_size=8, pregeneration_period=2, generation_period=1,
                attn_implementation="fused")
    base.update(kw)
    jp, tp = (j_parity(), t_parity()) if policy == "parity" else (j_default(), t_default())
    return (jms.MultiStateViTConfig(policy=jp, clustering=JSpectral(**clus), **base),
            tms.MultiStateViTConfig(policy=tp, clustering=TSpectral(**clus), **base))


def _pair(jcfg, tcfg, pix, seed=3):
    jmodel = jms.MultiStateViTForImageClassification(jcfg, num_labels=LABELS)
    key = jax.random.PRNGKey(seed)
    labels = np.arange(pix.shape[0]) % LABELS
    variables = jmodel.init({"params": key, "clustering": key}, jnp.asarray(pix),
                            jnp.asarray(labels))
    tmodel = tms.MultiStateViTForImageClassification(tcfg, LABELS)
    tmodel.load_state_dict(multistate_classifier_params_from_jax(variables, tcfg), strict=True)
    return jmodel, variables, tmodel, labels


def _margins(jcfg, variables, pix, key):
    """The JAX run's eigenvalue and KMeans margins (its encoder replayed
    with the per-layer states collected)."""
    enc = jms.MultiStateViTEncoderModel(jcfg)
    out = enc.apply({"params": variables["params"]["encoder"]}, jnp.asarray(pix), rng=key,
                    output_hidden_states=True, output_cluster_indices=True)
    return _event_margins(jcfg, out, key)


@pytest.mark.parametrize("policy,shared", [("parity", True), ("parity", False),
                                           ("default", True)])
def test_classifier_loss_and_grads_match_jax(policy, shared):
    """Loss and the gradient of every parameter against
    `jax.value_and_grad`, with events at layers 2 and 3 (the partitions
    equal, the JAX run's eigenvalue and KMeans margins >= 1e-3 from ties).
    f32 parity policy: loss 1e-5 relative, gradients 1e-3 of max(1,
    max |g|).  Default bf16 policy: loss 1e-2 relative and every gradient's
    cosine >= 0.999: `F.linear` adds the bias before it rounds to bf16,
    flax `Dense` after (ROADMAP.md section 3, bf16 bias adds), so the bf16
    activations differ by a rounding step.  No kernel launch on the CPU."""
    jcfg, tcfg = _cfgs(policy, shared)
    pix = _pixels(b=2, img=64, p=8, k=4, seed=1)
    jmodel, variables, tmodel, labels = _pair(jcfg, tcfg, pix)
    key = jax.random.PRNGKey(5)

    def jloss(v):
        out = jmodel.apply(v, jnp.asarray(pix), jnp.asarray(labels), rng=key)
        return out["loss"], out["last_cluster_indices"]

    (jl, jci), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    n = (tfused.fused_attention.launches, tfused.fused_attention_lse.launches,
         flash_attention_bwd.launches)
    out = tmodel(torch.from_numpy(pix), torch.from_numpy(labels), rng=JaxRng(key))
    out["loss"].backward()
    assert (tfused.fused_attention.launches, tfused.fused_attention_lse.launches,
            flash_attention_bwd.launches) == n
    eig_margin, km_margin = _margins(jcfg, variables, pix, key)
    assert eig_margin >= 1e-3 and km_margin >= 1e-3, (eig_margin, km_margin)
    np.testing.assert_array_equal(out["last_cluster_indices"].numpy(), np.asarray(jci))
    assert int(out["num_clusters"]) >= 2  # live splits
    assert out["logits"].dtype == torch.float32 and out["logits"].shape == (2, LABELS)
    want = multistate_classifier_params_from_jax(jg, tcfg)
    grads = dict(tmodel.named_parameters())
    assert set(want) == set(grads)
    if policy == "parity":
        np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-5)
        for name, w in want.items():
            tol = 1e-3 * max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(_np(grads[name].grad), w.numpy(), atol=tol, rtol=0,
                                       err_msg=name)
    else:
        np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=1e-2)
        for name, w in want.items():
            if float(w.abs().max()) > 0:
                assert _cos(grads[name].grad, w) >= 0.999, name


def test_two_trainer_steps_match_jax():
    """Two optimizer steps of the TX/RX tokens and the classifier (AdamW,
    the JAX example's `trainable`): the port's `Trainer` step against JAX's
    `Trainer.step_fn`, each step's clustering drawing the same keys
    (`fold_in(key, step)`).  Parameters <= 1e-5 after both steps; the frozen
    ones bit-equal to their start."""
    jcfg, tcfg = _cfgs()
    pix = _pixels(b=2, img=64, p=8, k=4, seed=1)
    jmodel, variables, tmodel, labels = _pair(jcfg, tcfg, pix)
    start = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    key = jax.random.PRNGKey(6)

    def jloss(params, batch, rng):
        out = jmodel.apply(params, *batch, rng=rng)
        return out["loss"], {}

    jtr = JTrainer(jloss, j_make_optimizer(1e-2, trainable=example.trainable), variables,
                   donate=False)
    step_key = {}

    def tloss(model, batch, gen):
        out = model(*batch, rng=JaxRng(step_key["key"]))
        return out["loss"], {}

    tr = Trainer(tloss, make_optimizer(1e-2, trainable=example.trainable), tmodel)
    jbatch = (jnp.asarray(pix), jnp.asarray(labels))
    tbatch = (torch.from_numpy(pix), torch.from_numpy(labels))
    for s in range(2):
        step_key["key"] = jax.random.fold_in(key, s)
        jtr.params, jtr.opt_state, jl, _ = jtr.step_fn(jtr.params, jtr.opt_state, jbatch,
                                                       step_key["key"])
        tl, _ = tr.step_fn(tr.model, tr.opt_state, tbatch, torch.Generator())
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = multistate_classifier_params_from_jax(jax.device_get(jtr.params), tcfg)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(_np(p.detach()), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        if not example.trainable(tuple(name.split("."))):
            assert torch.equal(p.detach(), start[name]), name
        else:
            assert not torch.equal(p.detach(), start[name]), name


def _tiny():
    return _cfgs(attn_implementation="auto")[1]


def test_example_cli_runs_on_the_cpu(capsys):
    """`main(argv, config)`: two steps of the example on the CPU with a
    tiny config print the per-step lines and the `loss a -> b` line."""
    losses = example.main(["--steps", "2", "--device", "cpu", "--batch", "2"], _tiny())
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert lines[0].startswith("step   0  loss ") and " acc " in lines[0]
    assert lines[1].startswith("step   1  loss ")
    verdict = "down" if losses[1] < losses[0] else "UP"
    assert lines[2] == f"loss {losses[0]:.4f} -> {losses[1]:.4f} ({verdict})"


def test_example_cli_refuses(monkeypatch):
    """No card and no `--device cpu`: it raises, it never falls back.
    `--dataset` and `--pretrained` name the ROADMAP items they need."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        example.main(["--steps", "1"], _tiny())
    with pytest.raises(NotImplementedError, match="item 10"):
        example.main(["--dataset", "x", "--device", "cpu"], _tiny())
    with pytest.raises(NotImplementedError, match="item 9"):
        example.main(["--pretrained", "x", "--device", "cpu"], _tiny())


def test_example_config_is_the_jax_examples():
    """The default config equals `examples/train_multistate.py`'s."""
    j = jms.MultiStateViTConfig(
        patch_size=16, image_size=224, pregeneration_period=4, generation_period=2,
        clustering=JSpectral(ncut_dim=8, num_sample=256, max_clusters=16,
                             eigenvalue_threshold=0.1, ncut_dist="rbf"))
    t = example.default_config(256)
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv), f.name
        else:
            assert jv == tv, f.name


def test_dropout_replays_from_the_generator():
    """Dropout, attention dropout and drop-path at 0.1 while training: two
    forwards with generators of the same seed give equal logits and
    gradients; another seed gives other logits.  The global RNG is not
    drawn from (its state is unchanged)."""
    _, tcfg = _cfgs(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                    drop_path_rate=0.1)
    model = tms.MultiStateViTForImageClassification(tcfg, LABELS).train()
    pix = torch.from_numpy(_pixels(b=2, img=64, p=8, seed=7))
    labels = torch.tensor([1, 3])

    def run(seed):
        model.zero_grad(set_to_none=True)
        out = model(pix, labels, rng=0, generator=torch.Generator().manual_seed(seed))
        out["loss"].backward()
        return out["logits"].detach(), model.encoder.backbone.transmitter_token.grad.clone()

    state = torch.get_rng_state()
    (l1, g1), (l2, g2), (l3, _) = run(5), run(5), run(6)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert not torch.equal(l1, l3)
    model.eval()
    with torch.no_grad():
        e1 = model(pix, rng=0, generator=torch.Generator().manual_seed(5))["logits"]
        e2 = model(pix, rng=0, generator=torch.Generator().manual_seed(6))["logits"]
    assert torch.equal(e1, e2)  # eval: no dropout
