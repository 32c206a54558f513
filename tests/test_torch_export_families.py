"""Export of the clustered families (`msvit_tpu_torch/export.py`) on the CPU,
at small shapes:

* (a) `torch.library.opcheck` on the registered ops K5
  `fused_attention`, K4 `fused_attention_inference`, K7
  `flash_attention` (a soft mask, a key-only mask, a bool mask), K9
  `packed_attention_int8_masked` and K10 `token_rows`, and each fake's
  shape, dtype and strides against the real output;
* (b) at a fixed batch of 2, the port's artifact of the tiny clustered
  multistate forward (`tests/test_torch_multistate.py::_cfgs`, one
  clustering event, drawing JAX's numbers through `JaxRng`) against JAX's
  own `export_forward` / `load_forward` artifact of the same forward:
  equal partitions (the clustering splits), hidden states <= 1e-3;
* (c) with the port's `Rng` and `polymorphic_batch=True`, the reloaded
  artifact bit-equal to the live model at batches 1, 2 and 5 (the NCut
  sample count `sym_min(num_sample, B * N)` changes between batches 1
  and 2), its graph holding K5;
* (d) the int8, banded and subsample artifacts: in
  `tests/test_torch_export_modes.py`, so that the two files' exports run
  on two test workers;
* (e) per-image clustering (`pool_batch=False`) exports at a symbolic
  batch: the reloaded spectral forward equals the live model on every
  element at batches 1, 2 and 3, and so do `fps_cluster` and
  `axis_align_cluster` alone.

Weights of (b) are drawn into `jax.eval_shape` trees (`random_tree`): one
JAX export, compiled once, in the file.  The clustering of (c)-(e) runs
fewer subspace and KMeans iterations than the model's defaults: the
graph, and so the export's time (~7 ms a node on the CPU), grows with
each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu import export as jexport
from msvit_tpu.models import multistate as jms
from msvit_tpu_torch.compat import multistate_params_from_jax
from msvit_tpu_torch.export import export_forward, load_forward
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.utils.rng import Rng
from test_torch_clustering import JaxRng
from test_torch_export import _graph_ops
from test_torch_multistate import _cfgs, _pixels
from test_torch_subsample import random_tree

# (c)-(e): one event at layer 1 (layer 0 runs the kernel, the last layer
# the plain path with probabilities); num_sample 24 against 16 tokens an
# image: 16 anchors at batch 1, 24 from batch 2 on
SMALL = dict(num_hidden_layers=2, pregeneration_period=1, generation_period=1)
SMALL_CLUSTERING = dict(num_sample=24, eig_iters=2, kmeans_iters=2)


def _x(b: int) -> torch.Tensor:
    return torch.from_numpy(_pixels(b=b, seed=10 + b))


def _port_model(**kw):
    clustering = {**SMALL_CLUSTERING, **kw.pop("clustering", {})}
    _, tcfg = _cfgs(**SMALL, clustering=clustering, **kw)
    gen = torch.Generator().manual_seed(4)
    return tcfg, tms.MultiStateViTEncoderModel(tcfg, generator=gen).eval()


def _outputs(out: dict) -> tuple:
    return out["last_hidden_state"], out["num_clusters"], out["last_cluster_indices"]


def _bit_equal_at(g, fn, params, batches=(1, 2, 5)) -> None:
    for b in batches:
        x = _x(b)
        with torch.no_grad():
            want = fn(params, x)
        got = g(params, x)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            assert torch.equal(a, w), b


# ------------------------------------------------------------ (a) opcheck


def _attention_cases():
    rng = np.random.default_rng(0)
    b, h, nq, nk, dh = 2, 2, 5, 7, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, dh)).astype(np.float32))
               for n in (nq, nk, nk))
    soft = torch.from_numpy(np.where(rng.random((b, 1, nq, nk)) < 0.7, 0.0, -100.0)
                            .astype(np.float32))
    key_only = torch.from_numpy(np.where(rng.random((b, 1, 1, nk)) < 0.7, 0.0, -1e30)
                                .astype(np.float32))
    bool_mask = torch.from_numpy(rng.random((b, h, nq, nk)) < 0.7)
    bool_mask[..., 0] = True
    return (q, k, v), {"soft": soft, "key_only": key_only, "bool": bool_mask, "none": None}


@pytest.mark.parametrize("mask", ["soft", "key_only", "bool", "none"])
@pytest.mark.parametrize("op", ["fused_attention", "fused_attention_inference",
                                "flash_attention"])
def test_attention_ops_pass_opcheck(op, mask):
    """K5, K4 and K7 as registered ops: `opcheck` (schema, fake against
    real, dispatch under a trace), f32 and bf16; the fake's shape, dtype
    and strides equal the real output's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    (q, k, v), masks = _attention_cases()
    fn = getattr(torch.ops.msvit, op).default
    for dt in (torch.float32, torch.bfloat16):
        args = (q.to(dt), k.to(dt), v.to(dt), masks[mask], 0.25, -1e9)
        torch.library.opcheck(fn, args)
        real = fn(*args)
        with FakeTensorMode() as mode:
            fake = fn(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args])
        assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype,
                                                           real.stride())


@pytest.mark.parametrize("int8_out", [False, True])
@pytest.mark.parametrize("mask", ["soft", "bool", "none"])
def test_int8_masked_op_passes_opcheck(mask, int8_out):
    """K9 as a registered op: `opcheck`, and the fake's shape and dtype."""
    rng = np.random.default_rng(1)
    qkv_q = torch.from_numpy(rng.integers(-127, 128, (2, 7, 48)).astype(np.int8))
    m = {"soft": torch.from_numpy(np.where(rng.random((2, 1, 7, 7)) < 0.7, 0.0, -100.0)
                                  .astype(np.float32)),
         "bool": torch.from_numpy(rng.random((2, 4, 7, 7)) < 0.7), "none": None}[mask]
    inv = torch.tensor(40.0) if int8_out else None
    args = (qkv_q, torch.tensor([0.01, 0.02, 0.03]), m, inv, 4, 0.25, int8_out, -1e9)
    fn = torch.ops.msvit.packed_attention_int8_masked.default
    torch.library.opcheck(fn, args)
    real = fn(*args)
    assert real.shape == (2, 7, 16)
    assert real.dtype == (torch.int8 if int8_out else torch.bfloat16)


def test_token_rows_op_passes_opcheck():
    """K10 as a registered op (the band table built inside it): `opcheck`,
    f32 and bf16."""
    rng = np.random.default_rng(2)
    c, n, heads = 3, 9, 2
    cid = torch.from_numpy(np.sort(rng.integers(0, c, (2, n)), axis=1))
    qkv = torch.from_numpy(rng.standard_normal((2, 2 * c + n, 3 * heads * 8))
                           .astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        args = (qkv.to(dt), cid, heads, c)
        torch.library.opcheck(torch.ops.msvit.token_rows.default, args)
        assert torch.ops.msvit.token_rows.default(*args).shape == (2, n, heads * 8)


def test_flop_formulas_of_the_new_ops():
    """`FlopCounterMode` counts each op as `aot_compile` does: 4 B H Nq Nk dh
    for K4, K5 and K7, 4 B N^2 D for K9, and for K10 4 D times the
    query-key pairs of its partition (each token's cluster and its RX)."""
    from torch.utils.flop_counter import FlopCounterMode

    (q, k, v), masks = _attention_cases()
    b, h, nq, dh = q.shape
    qkv_q = torch.zeros(2, 7, 48, dtype=torch.int8)
    cid = torch.tensor([[0, 0, 0, 1, 2], [1, 1, 2, 2, 2]])
    qkv = torch.zeros(2, 2 * 3 + 5, 3 * 16)
    calls = [(lambda: torch.ops.msvit.fused_attention(q, k, v, None, 0.25, -1e9),
              4 * b * h * nq * k.shape[2] * dh),
             (lambda: torch.ops.msvit.fused_attention_inference(q, k, v, None, 0.25, -1e9),
              4 * b * h * nq * k.shape[2] * dh),
             (lambda: torch.ops.msvit.flash_attention(q, k, v, masks["key_only"], 0.25, -1e9),
              4 * b * h * nq * k.shape[2] * dh),
             (lambda: torch.ops.msvit.packed_attention_int8_masked(
                 qkv_q, torch.ones(3), None, None, 4, 0.25, False, -1e9), 4 * 2 * 7 * 7 * 16),
             (lambda: torch.ops.msvit.token_rows(qkv, cid, 2, 3),
              4 * 16 * ((9 + 1 + 1) + (4 + 9) + 10))]
    for call, want in calls:
        counter = FlopCounterMode(display=False)
        with counter:
            call()
        assert counter.get_total_flops() == want


# ------------------------------------------- (b) against JAX's artifact


def test_fixed_batch_artifact_matches_jax_artifact():
    """The tiny clustered forward at batch 2 through both packages'
    artifacts, the port drawing JAX's numbers (`JaxRng`, traced into the
    graph as constants): the clustering splits (num_clusters >= 2), the
    partitions are equal, and the last hidden states agree to 1e-3 in
    f32 (the parity bar of tests/test_torch_multistate.py)."""
    jcfg, tcfg = _cfgs(num_hidden_layers=2, pregeneration_period=1, generation_period=1)
    pix = _pixels(seed=3)
    key = jax.random.PRNGKey(5)
    jmodel = jms.MultiStateViTEncoderModel(jcfg)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "clustering": key},
                            jnp.zeros(pix.shape, jnp.float32))
    variables = random_tree(shapes, 6)

    def jfn(v, x):
        out = jmodel.apply(v, x, rng=key)
        return out["last_hidden_state"], out["num_clusters"], out["last_cluster_indices"]

    want = jexport.load_forward(jexport.export_forward(jfn, (variables, jnp.asarray(pix))))(
        variables, jnp.asarray(pix))
    tmodel = tms.MultiStateViTEncoderModel(tcfg).eval()
    tmodel.load_state_dict(multistate_params_from_jax(variables, tcfg), strict=True)
    params = {k: v.detach() for k, v in tmodel.named_parameters()}

    def tfn(p, x):
        return _outputs(torch.func.functional_call(tmodel, p, (x,), {"rng": JaxRng(key)}))

    x = torch.from_numpy(pix)
    got = load_forward(export_forward(tfn, (params, x)))(params, x)
    assert int(want[1]) >= 2
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0], np.float32), atol=1e-3,
                               rtol=0)


# ----------------------------------------- (c) the symbolic batch, K5


def test_polymorphic_artifact_is_bit_equal_to_live():
    """The port's `Rng`, `polymorphic_batch=True`, the fused attention (K5
    on layer 0, one node in the graph): the reload equals the live model
    bit for bit at batches 1, 2 and 5, and the clustering splits."""
    _, model = _port_model(attn_implementation="fused")
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(p, x):
        return _outputs(torch.func.functional_call(model, p, (x,), {"rng": Rng(11)}))

    art = export_forward(fn, (params, _x(2)), polymorphic_batch=True)
    assert _graph_ops(art).count("msvit.fused_attention.default") == 1
    g = load_forward(art)
    _bit_equal_at(g, fn, params)
    assert int(g(params, _x(2))[1]) >= 2


# ------------------------------------------------ (e) per-image clustering


def test_per_image_clustering_exports_at_a_fixed_batch_only():
    """`pool_batch=False` runs over an image axis, each image on a stream
    folded from the seed in tensor ops: its artifact at a symbolic batch
    equals the live model on every element at batches 1, 2 and 3."""
    # the dense eigensolver: half the subspace solver's nodes, per image
    _, model = _port_model(clustering=dict(pool_batch=False, eig_method="eigh"))
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(p, x):
        return _outputs(torch.func.functional_call(model, p, (x,), {"rng": Rng(11)}))

    g = load_forward(export_forward(fn, (params, _x(2)), polymorphic_batch=True))
    _bit_equal_at(g, fn, params, batches=(1, 2, 3))
    assert g(params, _x(3))[1].shape == (3,)


@pytest.mark.parametrize("variant", ["fps", "axis"])
def test_per_image_fps_and_axis_align_export_at_a_symbolic_batch(variant):
    """`fps_cluster` and `axis_align_cluster` with `pool_batch=False` alone
    (8 tokens an image): exported at a symbolic batch, the reload equals
    the eager call on every element at batches 1, 2 and 3."""
    from msvit_tpu_torch.models.clustering import module as cm

    cfg = (cm.FPSClusteringConfig(pool_batch=False, num_sample=6, eig_method="eigh",
                                  fps_sample1=4, fps_sample2=2, fps_supersample2=4,
                                  fps_dim=4, ncut_dim=4, max_clusters=4)
           if variant == "fps" else
           cm.AxisAlignClusteringConfig(pool_batch=False, num_sample=6, ncut_dim=4,
                                        max_clusters=4))
    fn = cm.fps_cluster if variant == "fps" else cm.axis_align_cluster

    def run(params, parents, x):
        return fn(cfg, parents, x, Rng(5))

    def inputs(b):
        gen = torch.Generator().manual_seed(b)
        return torch.zeros(b, 8, dtype=torch.long), torch.randn(b, 8, 6, generator=gen)

    g = load_forward(export_forward(run, ({}, *inputs(2)), polymorphic_batch=True))
    for b in (1, 2, 3):
        want, got = run({}, *inputs(b)), g({}, *inputs(b))
        for a, w in zip(got, want):
            assert a.shape == w.shape and torch.equal(a, w), b
