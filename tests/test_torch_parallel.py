"""The port's parallel layer (`msvit_tpu_torch/parallel`) on 4 gloo CPU
ranks against the JAX package on the same converted weights, and sharded
port against unsharded port: counterparts of `tests/test_parallel.py`, the
sharded checkpoints of `tests/test_sharded_ckpt_and_remat.py`, the expert
parallel MoE of `tests/test_moe.py`, sequence sharding (with dropout), the
shard layouts and the divisibility errors.

One `RankPool` of 4 ranks serves the file (spawned once); the rank bodies
are in `tests/torch_parallel_bodies.py`, which imports no JAX.  Every job
has a time limit and every process group a timeout: a hung collective
fails its test.  Bars: port against JAX 1e-3 (the repo's f32 bar), sharded
against unsharded port 1e-5, unless a test says otherwise.
"""

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
from msvit_tpu_torch.compat import classifier_params_from_jax, vit_params_from_jax
from msvit_tpu_torch.compat.from_jax import _layer
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTForImageClassification as TClassifier
from msvit_tpu_torch.models.base.pruning import prune_heads
from msvit_tpu_torch.parallel import launch
from msvit_tpu_torch.parallel.sharding import check_tp, local_shard, partition_spec_for_params
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import Optimizer, train_step_fn

BODIES = "torch_parallel_bodies"
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
            patch_size=16)
LR = 1e-2


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(4, timeout=120, preload=(BODIES,)) as p:
        yield p


def run(pool, body, timeout=90, **kwargs):
    return pool.run(f"{BODIES}:{body}", timeout=timeout, **kwargs)


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


_CLASSIFIER = {}


def _classifier():
    """JAX classifier params (f32), converted, the batch and the labels."""
    if not _CLASSIFIER:
        model = JClassifier(JCfg(policy=j_parity(), attn_implementation="xla", **TINY), 10)
        pix = np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(np.float32)
        labels = np.random.default_rng(1).integers(0, 10, 8)
        params = _init(model, 0, jnp.asarray(pix[:1]))
        _CLASSIFIER.update(model=model, params=params, pix=pix, labels=labels,
                           state={k: v.numpy() for k, v in
                                  classifier_params_from_jax(_np_tree(params)).items()})
    return _CLASSIFIER


def _jax_loss(model, labels):
    def loss(p, x):
        logits = model.apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    return loss


def _jax_grads_and_adamw(steps=1):
    c = _classifier()
    loss = jax.jit(jax.value_and_grad(_jax_loss(c["model"], jnp.asarray(c["labels"]))))
    l0, g0 = loss(c["params"], jnp.asarray(c["pix"]))
    opt = optax.adamw(LR, weight_decay=1e-4)
    p, state = c["params"], opt.init(c["params"])
    for _ in range(steps):
        _, g = loss(p, jnp.asarray(c["pix"]))
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
    conv = classifier_params_from_jax
    return (float(l0), {k: v.numpy() for k, v in conv(_np_tree(g0)).items()},
            {k: v.numpy() for k, v in conv(_np_tree(p)).items()})


def _port_unsharded(steps=1, clip=None, mu_dtype=None):
    """The unsharded port: gradients of the first step, params after `steps`."""
    c = _classifier()
    model = TClassifier(TCfg(policy=t_parity(), **TINY), 10)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in c["state"].items()})
    opt = Optimizer(learning_rate=LR, weight_decay=1e-4, clip_norm=clip, mu_dtype=mu_dtype)
    step = train_step_fn(lambda m, b, g: (F.cross_entropy(m(b[0]), b[1]), {}), opt)
    state = opt.init(model)
    batch = (torch.from_numpy(c["pix"]), torch.from_numpy(c["labels"]).long())
    grads = None
    for i in range(steps):
        step(model, state, batch, torch.Generator().manual_seed(i))
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return grads, {k: v.numpy() for k, v in model.state_dict().items()}


def _max_dev(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in b)


def _adamw_close(got, want):
    """One AdamW step from equal weights: m/(sqrt(v)+eps) normalises each
    element by its own gradient's size, so a difference d in an element's
    gradient moves its update by ~lr d / |g|.  Two reductions of the same
    sum differ by f32 dust (d up to ~1e-9 here): harmless where |g| >= 1e-4
    (held to 1e-5), up to ~2 lr where the gradient is itself near zero (a
    bias whose exact gradient is zero: `tests/test_parallel.py`'s FSDP
    docstring), the bar of those elements.  A second step starts from
    weights that differ by that much, and every gradient moves: two steps
    are compared only between sharded steps with the same reductions, as
    `tests/test_parallel.py` does."""
    grads, _ = _port_unsharded(steps=1)
    for k in want:
        d = np.abs(np.asarray(got[k]) - np.asarray(want[k]))
        assert d.max() <= 2 * LR, (k, d.max())
        live = np.abs(grads[k]) >= 1e-4 if k in grads else np.ones(d.shape, bool)
        assert d[live].max(initial=0.0) <= 1e-5, (k, d[live].max())


def test_ranks_import_no_jax(pool):
    assert run(pool, "no_jax") == [False] * 4


@pytest.mark.parametrize("clip", [None, 0.5])
def test_dp_tp_train_step_matches_jax_and_single_device(pool, clip):
    """One dp=2 x tp=2 step: the loss, the gradients (averaged over "data",
    the partial ones summed over "model") and, with a clip, the clipped
    gradients, against the unsharded port (1e-5) and, unclipped, JAX's
    `value_and_grad` (1e-3)."""
    c = _classifier()
    out = run(pool, "train", cfg=TINY, state=c["state"], pixels=c["pix"],
              labels=c["labels"], tp=2, steps=1, lr=LR, clip=clip)
    grads, _ = _port_unsharded(steps=1, clip=clip)
    for r in out:
        assert _max_dev(r["grads"], grads) <= 1e-5
    if clip is None:
        loss, jgrads, _ = _jax_grads_and_adamw(steps=0)
        assert abs(out[0]["losses"][0] - loss) <= 1e-5
        assert _max_dev(out[0]["grads"], jgrads) <= 1e-3


def test_zero1_train_step_matches_and_shards_opt_state(pool):
    """ZeRO-1 at dp=2 x tp=2: two AdamW steps equal the plain sharded
    step's (1e-5: the same reductions), each rank keeps about 1/dp of the
    moments, and the first step is within the AdamW bar of the unsharded
    port's and of optax.adamw's."""
    c = _classifier()
    kw = dict(cfg=TINY, state=c["state"], pixels=c["pix"], labels=c["labels"], tp=2, lr=LR)
    plain = run(pool, "train", **kw)
    zero = run(pool, "train", zero1=True, **kw)
    for a, b in zip(zero, plain):
        assert _max_dev(a["params"], b["params"]) <= 1e-5
        assert a["moments"] <= 0.55 * b["moments"], (a["moments"], b["moments"])
    _, port = _port_unsharded()
    _, _, jparams = _jax_grads_and_adamw()
    _adamw_close(zero[0]["params1"], port)
    _adamw_close(zero[0]["params1"], jparams)


def test_zero1_train_step_with_a_clip(pool):
    """ZeRO-1 at dp=2 x tp=2 with a global-norm clip: the norm reads every
    rank's gradient slices, so two clipped steps equal the plain sharded
    step's (1e-5)."""
    c = _classifier()
    kw = dict(cfg=TINY, state=c["state"], pixels=c["pix"], labels=c["labels"], tp=2, lr=LR,
              clip=0.5)
    plain = run(pool, "train", **kw)
    zero = run(pool, "train", zero1=True, **kw)
    for a, b in zip(zero, plain):
        assert _max_dev(a["params"], b["params"]) <= 1e-5


def test_zero1_axis():
    """The largest axis that dp divides, not the tensor-parallel one; none
    for a group of one (a data group of one takes the plain step)."""
    from msvit_tpu_torch.parallel.train_step import zero1_axis

    assert zero1_axis((6, 8), 2) == 1
    assert zero1_axis((6, 8), 2, exclude=1) == 0
    assert zero1_axis((3, 5), 2) is None
    assert zero1_axis((6, 8), 1) is None


def test_fsdp_train_step_matches_and_shards_params(pool):
    """FSDP over 4 data ranks (fully_shard on every block and the model):
    the parameters are DTensors whose local part is a quarter, the
    gradients equal the data-parallel step's (1e-5), the first AdamW step
    is within the AdamW bar of it and of optax, and the moments are
    sharded."""
    c = _classifier()
    kw = dict(cfg=TINY, state=c["state"], pixels=c["pix"], labels=c["labels"], tp=1, lr=LR)
    dp = run(pool, "train", **kw)
    fsdp = run(pool, "train", fsdp=True, **kw)
    for a, b in zip(fsdp, dp):
        assert a["qkv_dtensor"] and not b["qkv_dtensor"]
        assert a["qkv_local"] * 4 == b["qkv_local"]
        assert a["moments"] <= 0.3 * b["moments"]
        assert _max_dev(a["grads"], b["grads"]) <= 1e-5
        _adamw_close(a["params1"], b["params1"])
    _, _, jparams = _jax_grads_and_adamw()
    _adamw_close(fsdp[0]["params1"], jparams)


def test_fsdp_train_step_with_a_bf16_mu(pool):
    """FSDP over 4 data ranks with a bf16 first moment (`mu_dtype`, the
    port's own AdamW update on each rank's local shards): mu is bf16 and
    sharded (a quarter of the data-parallel step's moments), the gradients
    equal the data-parallel bf16-mu step's (1e-5), and the first step is
    within the AdamW bar of it and of the unsharded bf16-mu step's."""
    c = _classifier()
    kw = dict(cfg=TINY, state=c["state"], pixels=c["pix"], labels=c["labels"], tp=1, lr=LR,
              mu_dtype="bfloat16")
    dp = run(pool, "train", **kw)
    fsdp = run(pool, "train", fsdp=True, **kw)
    _, port = _port_unsharded(mu_dtype=torch.bfloat16)
    for a, b in zip(fsdp, dp):
        assert a["mu_dtype"] == b["mu_dtype"] == "torch.bfloat16"
        assert a["qkv_dtensor"] and a["moments"] <= 0.3 * b["moments"]
        assert _max_dev(a["grads"], b["grads"]) <= 1e-5
        _adamw_close(a["params1"], b["params1"])
        _adamw_close(a["params1"], port)


def test_tp_forward_matches_replicated(pool):
    """tp=4 (one head a rank): logits against JAX and the unsharded port."""
    c = _classifier()
    out = run(pool, "forward", cfg=TINY, state=c["state"], pixels=c["pix"][:4], tp=4)
    want = np.asarray(c["model"].apply(c["params"], jnp.asarray(c["pix"][:4])))
    for r in out:
        np.testing.assert_allclose(r["got"], r["want"], atol=1e-5)
        np.testing.assert_allclose(r["got"], want, atol=1e-3)


def test_full_width_vit_b16_tensor_parallel_forward(pool):
    """ViT-B/16 @224 at full width under tp=4 (3 heads of 64 a rank):
    [2, 197, 768], finite, equal to the unsharded port (f32, 1e-4: 12
    blocks of 768-wide sums in another order)."""
    for r in run(pool, "vit_b16_tp", timeout=120):
        assert r["shape"] == (2, 197, 768) and r["finite"] and r["heads"] == 3
        assert r["dev"] <= 1e-4, r["dev"]


def test_multistate_dp_forward_matches_unsharded(pool):
    """The multistate encoder, clustering included, data parallel over 4
    ranks: each rank's shard of the global batch (a DTensor of [8, ...])
    equals the unsharded model on that shard.  The port's clustering draws
    for the batch it is given (JAX's GSPMD run draws for the global batch),
    so each shard is held against the unsharded model on that shard."""
    pix = np.random.default_rng(2).standard_normal((8, 32, 32, 3)).astype(np.float32)
    for r in run(pool, "multistate_dp", pixels=pix):
        assert r["global"] == (8, 32, 32, 3)
        assert r["dev"] <= 1e-5


def test_dryrun_multichip(pool):
    """`parallel.dryrun` on the file's 4 ranks: dp x tp with ZeRO-1,
    sequence sharding and expert parallelism, FSDP, and ring attention."""
    from msvit_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, pool=pool)
    assert all(r == out[0] for r in out)
    assert out[0]["ring_dev"] <= 1e-5


def test_distributed_helpers(pool):
    """In one process without a launcher `initialize` is a no-op, the
    shard is (0, 1) and `make_mesh` wants a card unless asked for the CPU;
    on 4 ranks the shard is (rank, 4) and `global_batch` wraps each rank's
    rows into one [16, 2] DTensor."""
    import torch.distributed as dist
    from msvit_tpu_torch.parallel import distributed as pdist, make_mesh

    pdist.initialize()
    assert not dist.is_initialized()
    assert pdist.host_shard() == (0, 1) and pdist.host_batch_size(32) == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    for rank, r in enumerate(run(pool, "helpers")):
        assert r["shard"] == (rank, 4) and r["per_rank"] == 8
        assert r["global_shape"] == (16, 2) and r["y_shape"] == (16,)
        np.testing.assert_array_equal(r["local"], np.arange(8.0).reshape(4, 2) + 100 * rank)


def test_make_mesh_after_a_new_default_group(tmp_path):
    """After `destroy_process_group` a new default group gets a new mesh,
    whose sub-groups work (the cached one's were destroyed with their
    group); within one group the mesh is built once."""
    import torch.distributed as dist
    from msvit_tpu_torch.parallel import distributed as pdist, make_mesh

    meshes = []
    for i in range(2):
        pdist.initialize(init_method=f"file://{tmp_path}/store{i}", world_size=1, rank=0,
                         backend="gloo")
        try:
            mesh = make_mesh(device_type="cpu")
            assert make_mesh(device_type="cpu") is mesh
            x = torch.ones(3)
            dist.all_reduce(x, group=mesh.get_group("data"))
            dist.all_reduce(x, group=mesh.get_group("model"))
            assert x.tolist() == [1.0, 1.0, 1.0]
            meshes.append(mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[0] is not meshes[1]


def _vit_state(seed=0):
    model = JViT(JCfg(policy=j_parity(), attn_implementation="xla",
                      **{**TINY, "num_hidden_layers": 1}))
    params = _init(model, seed, jnp.zeros((1, 32, 32, 3)))
    return {k: v.numpy() for k, v in vit_params_from_jax(_np_tree(params)).items()}


def test_sharded_checkpoint_roundtrip(pool, tmp_path):
    """A tp=2 state saved with torch.distributed.checkpoint restores onto
    zeroed tensors of its own layout and of a tp=4 layout: equal."""
    cfg = {**TINY, "num_hidden_layers": 1}
    for r in run(pool, "checkpoint_tp", cfg=cfg, state=_vit_state(), directory=str(tmp_path)):
        assert r == {2: 0.0, 4: 0.0}


def test_restore_fsdp_sharded_onto_plain_dp(pool, tmp_path):
    """Parameters sharded by FSDP over 4 data ranks (after a step), saved,
    restored onto plain replicated tensors: values equal."""
    pix = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    cfg = {**TINY, "num_hidden_layers": 1}
    for r in run(pool, "checkpoint_fsdp", cfg=cfg, state=_vit_state(), pixels=pix,
                 directory=str(tmp_path)):
        assert r["sharded"] > 0 and r["plain"] and r["dev"] == 0.0


def test_moe_expert_parallel_matches_replicated(pool):
    """Experts sharded 4-way on "model" (each rank one of 4): the encoder
    against JAX's replicated encoder and the unsharded port."""
    assert partition_spec_for_params(("mlp", "experts_in")).dim == 0
    cfg = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_experts=4)
    jenc = JEncoder(JCfg(policy=j_parity(), attn_implementation="xla", **cfg))
    x = np.random.default_rng(0).standard_normal((4, 6, 32)).astype(np.float32)
    variables = _init(jenc, 1, jnp.asarray(x))
    want = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(x))[0])
    state = {}
    for name, p in _np_tree(variables["params"]).items():
        _layer(state, "layer." + name.split("_")[1], p)
    state = {k: v.numpy() for k, v in state.items()}
    for r in run(pool, "moe_encoder", cfg=cfg, state=state, x=x):
        assert r["experts_local"] == (1, 32, 128)
        np.testing.assert_allclose(r["got"], r["want"], atol=1e-5)
        np.testing.assert_allclose(r["got"], want, atol=1e-3)


@pytest.mark.parametrize("mode", ["jax", "dropout"])
def test_sequence_sharding(pool, mode):
    """`sequence_sharding=True` at tp=4 (10 tokens: chunks of 3, the last
    padded), ViTModel.  "jax": eval forward against JAX (whose constraint
    changes no number) and the unsharded port.  "dropout": hidden and
    attention dropout and stochastic depth on, in training mode: the
    forward equals the unsharded port's, whose masks the sharded model
    slices (1e-5), and so does every gradient of sum(out * r) (1e-5 of the
    tensor's largest gradient: the tokens' sums run in another order)."""
    cfg = {**TINY, "image_size": 48, "sequence_sharding": True}
    jmodel = JViT(JCfg(policy=j_parity(), attn_implementation="xla", **cfg))
    pix = np.random.default_rng(4).standard_normal((2, 48, 48, 3)).astype(np.float32)
    params = _init(jmodel, 0, jnp.asarray(pix[:1]))
    state = {k: v.numpy() for k, v in vit_params_from_jax(_np_tree(params)).items()}
    if mode == "dropout":
        cfg.update(hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.1,
                   drop_path_rate=0.3)
    out = run(pool, "forward", cfg=cfg, state=state, pixels=pix, tp=4, num_labels=None,
              train=mode == "dropout", seed=5)
    for r in out:
        np.testing.assert_allclose(r["got"], r["want"], atol=1e-5)
        assert r["grad_dev"] <= 1e-5, r["grad_dev"]
    if mode == "jax":
        want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(pix))["last_hidden_state"])
        np.testing.assert_allclose(out[0]["got"], want, atol=1e-3)
    else:
        assert not np.allclose(out[0]["got"], out[0]["want"] * 0)


def test_shard_layouts_qkv_and_swiglu(pool):
    """The qkv rows a rank holds are q, k and v of its heads (the [3, H*dh]
    view), SwiGLU's weights_in rows its units of both halves (the [2, h]
    view); `shard_params` of the full state equals what `parallelize` cuts,
    and a SwiGLU trunk under tp=2 equals the unsharded one."""
    h, dh, d = 4, 3, 5
    w = torch.arange(3 * h * dh * d, dtype=torch.float32).reshape(3 * h * dh, d)
    got = local_shard(w, partition_spec_for_params(("attention", "qkv", "weight")), 1, 2)
    want = w.reshape(3, h, dh, d)[:, 2:].reshape(-1, d)
    assert torch.equal(got, want)
    wi = torch.arange(2 * 8 * d, dtype=torch.float32).reshape(16, d)
    got = local_shard(wi, partition_spec_for_params(("mlp", "weights_in", "weight")), 0, 2)
    assert torch.equal(got, torch.cat([wi[0:4], wi[8:12]]))
    cfg = {**TINY, "use_swiglu_ffn": True}
    model = TClassifier(TCfg(policy=t_parity(), **cfg), 10)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert run(pool, "shard_layouts", cfg=cfg, state=state) == [True] * 4
    pix = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    for r in run(pool, "forward", cfg=cfg, state=state, pixels=pix, tp=2):
        np.testing.assert_allclose(r["got"], r["want"], atol=1e-5)


@pytest.mark.parametrize("field", ["num_attention_heads", "mlp_hidden_size",
                                   "swiglu_hidden_size", "num_experts", "pruned"])
def test_indivisible_tp_raises(field):
    """A size that tp does not divide raises ValueError naming the field,
    a pruned trunk's H' included."""
    base = TCfg(**TINY)
    cfg, tp, name = {
        "num_attention_heads": (TCfg(**{**TINY, "num_attention_heads": 2}), 4, field),
        "mlp_hidden_size": (TCfg(**{**TINY, "mlp_ratio": 25 / 64}), 2, "mlp_hidden_size=25"),
        "swiglu_hidden_size": (TCfg(**{**TINY, "hidden_size": 60, "num_attention_heads": 6,
                                       "use_swiglu_ffn": True}), 3, "swiglu_hidden_size=160"),
        "num_experts": (TCfg(**{**TINY, "num_experts": 3}), 2, field),
        "pruned": (None, 2, "num_attention_heads=3"),
    }[field]
    if cfg is None:
        _, cfg = prune_heads(TClassifier(base, 10).vit.state_dict(), base, {0: [1], 1: [2]})
        name = "num_attention_heads=3"
    with pytest.raises(ValueError, match=name):
        check_tp(cfg, tp)
