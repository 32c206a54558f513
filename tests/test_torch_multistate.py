"""PyTorch port, multistate serving slice against the JAX package (CPU):

* the plain versions of K4 (`fused_attention_inference`) and K5
  (`fused_attention`) against the JAX Pallas kernels in interpret mode;
* the attention dispatch ("auto" / "fused" / "flash") against JAX's rule;
* `MultiStateViTEncoderModel` (bf16 trunk in the f32 parity policy) with
  and without clustering events, and the int8 `quantized_multistate_apply`,
  on weights converted by `multistate_params_from_jax`, the clustering
  drawing JAX's numbers through `JaxRng`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msvit_tpu.ops.attention as jattn
import msvit_tpu.ops.flash_attention as jflash
import msvit_tpu.ops.fused_attention as jfused
from msvit_tpu.models import multistate as jms
from msvit_tpu.models.clustering import SpectralClusteringConfig as JSpectral
from msvit_tpu.models.clustering.module import _ncut_matmul_dtype
from msvit_tpu.ops.kmeans import kmeans as jkmeans
from msvit_tpu.ops.ncut import ncut as jncut, ncut_shared as jncut_shared
from msvit_tpu.settings import parity_policy as j_parity
import msvit_tpu_torch.ops.attention as tattn
import msvit_tpu_torch.ops.flash_attention as tflash
import msvit_tpu_torch.ops.fused_attention as tfused
from msvit_tpu_torch.compat import act_scales_from_jax, multistate_params_from_jax
from msvit_tpu_torch.models import multistate as tms
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig as TSpectral
from msvit_tpu_torch.settings import parity_policy as t_parity
from test_torch_clustering import JaxRng

B, H, N, DH = 2, 4, 40, 64
C = 4  # 2C + 32 tokens = N


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cos(a, b):
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ----------------------------------------------------- K4 / K5 (plain) ----


def _qkv(seed, nq=N, nk=N):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, nq, DH)).astype(np.float32)
    k = rng.standard_normal((B, H, nk, DH)).astype(np.float32)
    v = rng.standard_normal((B, H, nk, DH)).astype(np.float32)
    return q, k, v


def _mask(kind, seed=0, nq=N, nk=N):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "multistate":  # the soft mask of a real partition, [B, 1, N, N]
        ci = rng.integers(0, 3, (B, N - 2 * C))
        m = jms.build_multistate_attention_mask(jnp.asarray(ci), jnp.asarray(3), C)
        return np.array(jnp.where(m, 0.0, -100.0), np.float32)
    m = rng.random((B, H, nq, nk)) < 0.7  # per-head bool
    m[:, :, 0, :] = True  # (the fully masked row is test_fully_masked_row_deviation's)
    return m


_CASES = [("none", None, N), ("multistate", "multistate", N),
          ("bool_per_head", "bool", N), ("cross_context", "bool", 56)]
# f32: summation order only; bf16: both sides round p to bf16 before P.V,
# the f32 sums in another order move a rounding: 2e-2 (the K1 bar)
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,case", [("K5", c[0]) for c in _CASES]
                         + [("K4", c[0]) for c in _CASES if c[2] == N])
def test_fused_plain_matches_jax(kernel, case, dtype):
    """K5 plain vs `fused_attention` and K4 plain vs
    `fused_attention_inference` (JAX, interpret mode), [2,4,40,64]; K/V of
    56 tokens for the cross-context case (K5 only: JAX serves it with K5).
    Tolerance: f32 1e-5, bf16 2e-2 max abs.  The wrapper on CPU tensors
    runs the plain version (no launch).  Each case computes its own JAX
    output (no fixture shared across the module: the file's first case
    once also made that fixture's first JAX call)."""
    _, kind, nk = next(c for c in _CASES if c[0] == case)
    q, k, v = _qkv(1, nk=nk)
    m = _mask(kind, 2, nk=nk)
    jfn = jfused.fused_attention if kernel == "K5" else jfused.fused_attention_inference
    want = _np(jfn(*(jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v)),
                   mask=None if m is None else jnp.asarray(m)))
    tdt = getattr(torch, dtype)
    fn = tfused.fused_attention if kernel == "K5" else tfused.fused_attention_inference
    before = fn.launches
    got = fn(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
             mask=None if m is None else torch.from_numpy(m))
    assert fn.launches == before
    assert got.dtype == tdt and got.shape == (B, H, N, DH)
    got = _np(got)
    if kernel == "K4":
        # rows whose every logit is below -80 (the empty cluster slots'
        # fully penalised rows): the shave makes them fully masked rows,
        # pinned by test_fully_masked_row_deviation
        flat = _flat_rows(q, k, m)
        assert (case == "multistate") == bool(flat.any())
        got, want = got[~flat], want[~flat]
    np.testing.assert_allclose(got, want, atol=_TOL[dtype], rtol=0)


# (Nq, Nk, dh, mask): Nq and Nk one short of and one past a 64-row tile and
# two tiles plus one, Nq != Nk both ways; dh 16, 64 and 128; bool (every row
# keeps key 0) and additive soft masks, broadcast and per head
_TILE_EDGES = [(63, 65, 16, "bool"), (65, 129, 64, "additive_per_head"),
               (129, 63, 128, "additive"), (129, 129, 64, "bool_per_head")]


def _edge_mask(kind, rng, nq, nk):
    hm = H if kind.endswith("per_head") else 1
    if kind.startswith("bool"):
        m = rng.random((B, hm, nq, nk)) < 0.7
        m[..., 0] = True
        return m
    return np.where(rng.random((B, hm, nq, nk)) < 0.3, -100.0, 0.0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,dh,kind", _TILE_EDGES)
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_fused_plain_matches_jax_at_tile_edges(kernel, nq, nk, dh, kind, dtype):
    """The contract the card's bf16 tensor-core K4 and K5 are held to,
    where their 64-row tiles have edges: K5 plain vs `fused_attention` and
    K4 plain vs `fused_attention_inference` (JAX, interpret mode), 4 heads.
    Tolerance: f32 1e-5, bf16 2e-2 max abs (both sides round p to bf16
    into P.V; f32 sums in another order).  No row is fully masked: JAX's
    keys padded to 128 weigh e^-80 in K4's l beside an attended key's ~1,
    nothing in K5's."""
    rng = np.random.default_rng(nq * 3 + nk + dh)
    q, k, v = (rng.standard_normal((B, H, n, dh)).astype(np.float32) for n in (nq, nk, nk))
    m = _edge_mask(kind, rng, nq, nk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfn = jfused.fused_attention if kernel == "K5" else jfused.fused_attention_inference
    tfn = tfused.fused_attention if kernel == "K5" else tfused.fused_attention_inference
    want = jfn(*(jnp.asarray(t, jdt) for t in (q, k, v)), mask=jnp.asarray(m))
    got = tfn(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), mask=torch.from_numpy(m))
    assert got.dtype == tdt and got.shape == (B, H, nq, dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dtype], rtol=0)


def _flat_rows(q, k, m):
    """[B, H, Nq] bool: rows whose scaled, masked logits are all < -80."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / DH**0.5
    if m is not None:
        s = s + m if m.dtype != bool else np.where(m, s, -np.inf)
    return s.max(-1) < -80


@pytest.mark.parametrize("kernel,mask", [("K5", "bool"), ("K4", "bool"),
                                         ("K4", "multistate")])
def test_fully_masked_row_deviation(kernel, mask):
    """Fully masked rows: a bool row with every key masked, and (K4 only)
    the multistate soft mask's fully penalised rows (every logit near -100,
    all clipped to -80 by the shave).  JAX's kernels pad Nk = 40 up to 128
    and count the padded keys (zero V rows) in the denominator: such a row
    is sum(V) / 128.  The port gives mean(V) over the 40 real keys (the
    deviation the port states).  Every other row agrees with JAX to 1e-5
    (f32)."""
    q, k, v = _qkv(3)
    if mask == "bool":
        m = np.random.default_rng(4).random((B, H, N, N)) < 0.7
        m[:, :, 0, :] = True
        m[0, 1, 5, :] = False  # the fully masked row
        flat = np.zeros((B, H, N), bool)
        flat[0, 1, 5] = True
    else:
        m = _mask("multistate", 4)
        flat = _flat_rows(q, k, m)
    assert flat.sum() >= 1
    jfn = jfused.fused_attention if kernel == "K5" else jfused.fused_attention_inference
    tfn = tfused.fused_attention if kernel == "K5" else tfused.fused_attention_inference
    want = _np(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(m)))
    got = _np(tfn(*(torch.from_numpy(t) for t in (q, k, v)), mask=torch.from_numpy(m)))
    vb = np.broadcast_to(v[:, :, None], (B, H, N, N, DH))[flat]
    np.testing.assert_allclose(want[flat], vb.sum(1) / 128, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[flat], vb.mean(1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[~flat], want[~flat], atol=1e-5, rtol=0)


def test_k5_all_minus_inf_row_gives_zeros():
    """An additive -inf row: l == 0, the output row is zeros (the JAX
    kernel's l == 0 guard), the rest finite."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(5))
    m = torch.zeros(B, 1, N, N)
    m[1, 0, 7, :] = -torch.inf
    got = tfused.fused_attention(q, k, v, mask=m)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1, :, 7], torch.zeros(H, DH))


# ------------------------------------------------------------ dispatch ----


def _record(monkeypatch, module, names, log):
    for name in names:
        def fake(q, k, v, *a, _name=name, **kw):
            log.append(_name)
            out = q.new_zeros(q.shape) if isinstance(q, torch.Tensor) else jnp.zeros_like(q)
            return (out, None) if _name == "xla_attention" else out
        monkeypatch.setattr(module, name, fake)


_ROUTES = [  # (nq, nk, output_probs, mask_ndim, inference)
    (16, 600, False, None, False),  # cross-context, >= 512 kv: K5
    (16, 600, False, 4, False),
    (600, 600, False, 4, True),  # self-attention, serving: K4
    (600, 600, True, 4, False),  # probabilities requested: plain
    (16, 100, False, None, False),  # < 512 kv: plain
    (600, 16, False, 4, False),  # Q longer than K/V, < 512 kv: plain
    (600, 600, False, 3, False),  # 3D mask: plain
    # one head's padded f32 scores plus an additive mask tile of the same
    # size against JAX's 12 MiB budget (`_fused_eligible`): 1152 fits,
    # 1153 (padded to 1280) does not
    (1152, 1152, False, 4, False),  # K5
    (1153, 1153, False, 4, False),  # K7
    (1800, 1800, False, 4, False),  # K7
    (1800, 1800, False, 4, True),  # K7: the flash route has no shaved variant
    (16, 3168, False, 4, False),  # cross-context K/V of the 448-px trunk: K5
    (3168, 3168, False, 4, True),  # the 448-px trunk, serving: K7
    # unmasked: scores alone, 1664 fits, 1665 (padded to 1792) does not
    (1664, 1664, False, None, False),  # K5
    (1665, 1665, False, None, False),  # K7
]


@pytest.mark.parametrize("nq,nk,probs,mask_ndim,inference", _ROUTES)
def test_auto_dispatch_matches_jax_rule(monkeypatch, nq, nk, probs, mask_ndim, inference):
    """The port's "auto" on a tensor that is not on the CPU (meta, standing
    for the card) takes the route JAX's "auto" takes on the TPU (JAX's own
    dispatch code, run with `_on_tpu` forced): K/V longer than Q included,
    which an earlier version of the port's rule sent to the plain path,
    and the long shapes beyond `_fused_eligible`'s budget (K7)."""
    jlog, tlog = [], []
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    _record(monkeypatch, jfused, ["fused_attention", "fused_attention_inference"], jlog)
    _record(monkeypatch, jflash, ["flash_attention"], jlog)
    _record(monkeypatch, jattn, ["xla_attention"], jlog)
    _record(monkeypatch, tfused, ["fused_attention", "fused_attention_inference"], tlog)
    _record(monkeypatch, tflash, ["flash_attention"], tlog)
    _record(monkeypatch, tattn, ["xla_attention"], tlog)
    shape_m = {None: None, 4: (1, 1, nq, nk), 3: (1, nq, nk)}[mask_ndim]
    jq, jk = jnp.zeros((1, 2, nq, 8)), jnp.zeros((1, 2, nk, 8))
    jattn.multi_head_attention(jq, jk, jk, mask=None if shape_m is None else jnp.zeros(shape_m),
                               output_probs=probs, inference=inference)
    tq, tk = torch.empty((1, 2, nq, 8), device="meta"), torch.empty((1, 2, nk, 8), device="meta")
    tattn.multi_head_attention(
        tq, tk, tk, mask=None if shape_m is None else torch.empty(shape_m, device="meta"),
        output_probs=probs, inference=inference)
    assert tlog == jlog and len(tlog) == 1


def test_cpu_dispatch_takes_the_plain_path():
    """On the CPU, "auto" at >= 512 kv tokens (cross-context included)
    takes the einsum path and "fused" the kernels' plain versions: no
    launch, the same numbers."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 600, 8)).astype(np.float32))
    n5, n4 = tfused.fused_attention.launches, tfused.fused_attention_inference.launches
    auto, _ = tattn.multi_head_attention(q, k, k)
    fused, _ = tattn.multi_head_attention(q, k, k, implementation="fused")
    served, _ = tattn.multi_head_attention(q, k, k, implementation="fused", inference=True)
    assert (tfused.fused_attention.launches, tfused.fused_attention_inference.launches) == (n5, n4)
    want, _ = tattn.xla_attention(q, k, k)
    for got in (auto, fused, served):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_off_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU goes to a kernel or raises: "auto",
    "fused" and "flash" at 600 kv tokens reach the kernel wrappers, which
    have no kernel for a meta tensor."""
    q = torch.empty((1, 2, 16, 8), device="meta")
    k = torch.empty((1, 2, 600, 8), device="meta")
    for impl, inference in (("auto", False), ("auto", True), ("fused", False),
                            ("flash", False), ("flash", True)):
        with pytest.raises(ValueError, match="no kernel"):
            tattn.multi_head_attention(q, k, k, implementation=impl, inference=inference)


# --------------------------------------------------------------- slice ----


def _cfgs(**kw):
    """The tiny config of tests/test_multistate_int8.py: hidden 256, 4 heads
    (dh 64), 3 layers, 64 px at patch 16 (16 tokens + 2*4 TX/RX), f32
    parity policy, the einsum attention path."""
    clus = dict(ncut_dim=4, num_sample=16, max_clusters=C, eigenvalue_threshold=0.1)
    clus.update(kw.pop("clustering", {}))
    base = dict(hidden_size=256, num_attention_heads=4, num_hidden_layers=3,
                image_size=64, patch_size=16, attn_implementation="xla")
    base.update(kw)
    return (jms.MultiStateViTConfig(policy=j_parity(), clustering=JSpectral(**clus), **base),
            tms.MultiStateViTConfig(policy=t_parity(), clustering=TSpectral(**clus), **base))


def _pixels(b=2, img=64, p=16, k=3, seed=0):
    """Images of patches copied from k prototypes (plus a little noise),
    so the tokens form k well-separated groups and clustering splits."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((k, p, p, 3)) * 3.0
    g = img // p
    x = protos[rng.integers(0, k, (b, g, g))] + 0.1 * rng.standard_normal((b, g, g, p, p, 3))
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, img, img, 3).astype(np.float32)


def _pair(jcfg, tcfg, pix, seed=3):
    model = jms.MultiStateViTEncoderModel(jcfg)
    key = jax.random.PRNGKey(seed)
    variables = model.init({"params": key, "clustering": key}, jnp.asarray(pix))
    tmodel = tms.MultiStateViTEncoderModel(tcfg)
    tmodel.load_state_dict(multistate_params_from_jax(variables, tcfg), strict=True)
    return model, variables, tmodel.eval()


def _event_margins(jcfg, out, key):
    """Replays the JAX run's clustering events (per-parent or shared-anchor
    NCut) from its collected hidden states and ids: the smallest distance of an eigenvalue to the
    threshold, and the smallest relative gap between a member token's
    nearest and second-nearest active KMeans center.  Equality of the two
    packages' partitions rests on both being far from 0."""
    cc = jcfg.clustering
    eig_margin, km_margin = np.inf, np.inf
    rng, bound = key, 1
    for i in range(jcfg.num_hidden_layers):
        if not (i >= jcfg.pregeneration_period and i % jcfg.generation_period == 0):
            continue
        rng, step = jax.random.split(rng)
        x = out["hidden_states"][i].astype(jnp.float32)
        parent = out["cluster_indices"][i]
        sets = ([(parent.reshape(-1), x.reshape(-1, x.shape[-1]), step)] if cc.pool_batch
                else list(zip(parent, x, jax.random.split(step, x.shape[0]))))
        cb = min(bound, cc.max_clusters)
        for fp, fx, k in sets:
            member = fp[None, :] == jnp.arange(cb)[:, None]
            keys = jax.random.split(k, 2 * cc.max_clusters)
            ns = cc.late_num_sample if (cb > 1 and cc.late_num_sample) else cc.num_sample
            common = dict(num_sample=ns, distance=cc.ncut_dist,
                          gamma=cc.affinity_focal_gamma, eig_method=cc.eig_method,
                          eig_iters=cc.eig_iters, matmul_dtype=_ncut_matmul_dtype(cc))
            if cc.shared_anchors:
                vecs, vals = jncut_shared(fx, cc.ncut_dim, keys[0], member,
                                          anchors_per_parent=cc.anchors_per_parent,
                                          **common)
            else:
                vecs, vals = jax.vmap(lambda m, kk: jncut(
                    fx, cc.ncut_dim, kk, mask=m, **common))(member, keys[:cb])
            has = np.asarray(member.any(1))
            v = np.asarray(vals)[has]
            eig_margin = min(eig_margin, float(np.abs(v - cc.eigenvalue_threshold).min()))
            n_child = np.minimum(np.maximum((v > cc.eigenvalue_threshold).sum(-1), 1), cc.max_clusters)
            for p, kk in zip(np.flatnonzero(has), keys[cc.max_clusters:][np.flatnonzero(has)]):
                act = np.arange(cc.ncut_dim) < n_child[list(np.flatnonzero(has)).index(p)]
                if act.sum() < 2:
                    continue
                sub = vecs[p] * jnp.asarray(act)[None]
                _, cen = jkmeans(sub, cc.ncut_dim, kk, iters=cc.kmeans_iters,
                                 active=jnp.asarray(act), mask=member[p])
                d2 = ((np.asarray(sub)[:, None] - np.asarray(cen)[None]) ** 2).sum(-1)[:, act]
                d2 = np.sort(d2[np.asarray(member[p])], axis=1)
                km_margin = min(km_margin, float(((d2[:, 1] - d2[:, 0]) / d2[:, 1].max()).min()))
        bound = min(bound * cc.ncut_dim, cc.max_clusters)
    return eig_margin, km_margin


def _close(got, want, atol=1e-3):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_model_without_clustering_matches_jax(impl):
    """No clustering event (pregeneration beyond the depth): hidden
    states, TX tokens and RX -> TX attentions <= 1e-3 (the parity bar).
    "auto" runs the port's packed path (K1's plain version, shaved) where
    JAX on the CPU runs einsum: the valid cluster slot (1 of 4) is
    compared, the empty slots' fully penalised rows are flattened by the
    shave there (as on the TPU) and not here."""
    jcfg, tcfg = _cfgs(pregeneration_period=99, attn_implementation=impl)
    pix = _pixels(seed=1)
    model, variables, tmodel = _pair(jcfg, tcfg, pix)
    want = model.apply(variables, jnp.asarray(pix), rng=jax.random.PRNGKey(7))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(pix), rng=JaxRng(jax.random.PRNGKey(7)))
    nc = 1 if impl == "auto" else C
    assert int(got["num_clusters"]) == int(want["num_clusters"]) == 1
    _close(got["last_hidden_state"], want["last_hidden_state"])
    _close(got["cluster_tokens"][:, :nc], want["cluster_tokens"][:, :nc])
    _close(got["receiver_to_transmitter_attentions"][:, :, :nc, :nc],
           want["receiver_to_transmitter_attentions"][:, :, :nc, :nc])


@pytest.mark.parametrize("pool_batch", [True, False])
def test_model_with_clustering_matches_jax(pool_batch):
    """Clustering events at layers 1 and 2 (pooled ids across the batch, or
    per image): last_cluster_indices and num_clusters equal JAX's; hidden
    states, TX tokens and RX -> TX attentions <= 1e-3.  The JAX run's
    eigenvalues stay >= 1e-3 from the threshold and every member token's
    two nearest KMeans centers >= 1e-3 apart (relative), so the equality
    is not luck at a tie."""
    jcfg, tcfg = _cfgs(pregeneration_period=1, generation_period=1,
                       clustering=dict(pool_batch=pool_batch))
    pix = _pixels(seed=3)
    model, variables, tmodel = _pair(jcfg, tcfg, pix)
    key = jax.random.PRNGKey(5)
    want = model.apply(variables, jnp.asarray(pix), rng=key, output_hidden_states=True,
                       output_cluster_indices=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(pix), rng=JaxRng(key), output_hidden_states=True,
                     output_cluster_indices=True)
    eig_margin, km_margin = _event_margins(jcfg, want, key)
    assert eig_margin >= 1e-3 and km_margin >= 1e-3, (eig_margin, km_margin)
    assert int(np.min(np.asarray(want["num_clusters"]))) >= 2  # live splits
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    np.testing.assert_array_equal(got["num_clusters"].numpy(), np.asarray(want["num_clusters"]))
    for a, b in zip(got["cluster_indices"], want["cluster_indices"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(got["last_hidden_state"], want["last_hidden_state"])
    _close(got["cluster_tokens"], want["cluster_tokens"])
    _close(got["receiver_to_transmitter_attentions"],
           want["receiver_to_transmitter_attentions"])


@pytest.mark.parametrize("events", [False, True])
def test_quantized_apply_matches_jax(events):
    """int8 path: weights quantized by each package from the same f32
    weights (equal int8 values), JAX's calibrated scales converted by
    `act_scales_from_jax`, kernels on (the einsum attention on the CPU in
    both): cosine >= 0.999 (the bar of test_torch_vit's int8 test) for the
    hidden states and TX tokens; with clustering events the partitions
    are equal."""
    jcfg, tcfg = _cfgs(pregeneration_period=1 if events else 99, generation_period=1)
    pix = _pixels(seed=0)
    _, variables, tmodel = _pair(jcfg, tcfg, pix)
    jq = jms.quantize_multistate_params(variables["params"])
    tq = tms.quantize_multistate_params(tmodel)
    w = jq["backbone"]["layers"]["layer_1"]["fc1"]["w"]
    np.testing.assert_array_equal(tq["backbone"]["layers"]["layer_1"]["fc1"]["w"].values.numpy(),
                                  np.asarray(w.values).T)
    key = jax.random.PRNGKey(9)
    js = jms.calibrate_multistate_act_scales(jq, jcfg, jnp.asarray(pix), key, use_kernels=False)
    want = jms.quantized_multistate_apply(jq, jcfg, jnp.asarray(pix), key, act_scales=js,
                                          use_kernels=True)
    got = tms.quantized_multistate_apply(tq, tcfg, torch.from_numpy(pix), JaxRng(key),
                                         act_scales=act_scales_from_jax(js), use_kernels=True)
    assert got["last_hidden_state"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["last_cluster_indices"].numpy(),
                                  np.asarray(want["last_cluster_indices"]))
    assert _cos(got["last_hidden_state"], want["last_hidden_state"]) >= 0.999
    assert _cos(got["cluster_tokens"], want["cluster_tokens"]) >= 0.999
    assert _cos(got["receiver_to_transmitter_attentions"],
                want["receiver_to_transmitter_attentions"]) >= 0.999


def test_calibrated_scale_sites_match_jax():
    """The port's calibration records JAX's sites (patch, qkv_i, attn_i,
    proj_i, fc1_i, fc2_i), within 1e-2 relative of JAX's values, and
    `act_scales_from_jax` takes every one of them."""
    jcfg, tcfg = _cfgs(pregeneration_period=99)
    pix = _pixels(seed=2)
    _, variables, tmodel = _pair(jcfg, tcfg, pix)
    key = jax.random.PRNGKey(1)
    js = jms.calibrate_multistate_act_scales(
        jms.quantize_multistate_params(variables["params"]), jcfg, jnp.asarray(pix), key,
        use_kernels=False)
    ts = tms.calibrate_multistate_act_scales(tms.quantize_multistate_params(tmodel), tcfg,
                                             torch.from_numpy(pix), JaxRng(key))
    conv = act_scales_from_jax(js)
    assert set(ts) == set(js) == set(conv)
    assert {k.split("_")[0] for k in ts} == {"patch", "qkv", "attn", "proj", "fc1", "fc2"}
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-2)
        np.testing.assert_array_equal(conv[k].numpy(), np.asarray(js[k]))


def test_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jms.MultiStateViTConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tms.MultiStateViTConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(jd) == dataclasses.asdict(td), n
        else:
            assert jd == td, n
    assert tms.MultiStateViTConfig().max_clusters == jms.MultiStateViTConfig().max_clusters


def test_attention_mask_matches_jax():
    rng = np.random.default_rng(8)
    ci = rng.integers(0, 3, (2, 12))
    for nc in (np.asarray(3), np.asarray([2, 3])):
        want = np.asarray(jms.build_multistate_attention_mask(jnp.asarray(ci), jnp.asarray(nc), 4))
        got = tms.build_multistate_attention_mask(torch.from_numpy(ci), torch.from_numpy(nc), 4)
        np.testing.assert_array_equal(got.numpy(), want)
