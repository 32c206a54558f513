"""PyTorch port, the saccadic family against the JAX package (CPU), at a
tiny config (width 32, 4 heads, 2 refiner layers, rank 4, patterns of
complexity 1 and 2 with 8 each, beam 4, 64 px, 16-px glimpses): both
log-pdf routes, the beam matcher, both refiner attentions, the refiner,
the glimpse embeddings, the batched lockstep run, the serial controller,
the three losses and their gradients, three AdamW steps of
`train_saccadic`'s objective against optax, and both examples' CLIs.
Weights go through `saccadic_params_from_jax`.  f32; the bars are 1e-3
absolute unless a test says otherwise; one jitted JAX function per use,
cached."""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models import saccadic as jsac
from msvit_tpu.models.saccadic import losses as jl
from msvit_tpu.models.saccadic import pattern as jpat
from msvit_tpu.models.saccadic.batched import batched_saccade_run as j_batched
from msvit_tpu.models.saccadic.refiner import EagerSelfAttention as JEager
from msvit_tpu.models.saccadic.refiner import QuadraticSelfAttention as JQuad
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import saccadic_params_from_jax
from msvit_tpu_torch.examples import saccadic_demo as demo
from msvit_tpu_torch.examples import train_saccadic as ex
from msvit_tpu_torch.models import saccadic as tsac
from msvit_tpu_torch.models.saccadic import pattern as tpat
from msvit_tpu_torch.settings import parity_policy as t_parity
from msvit_tpu_torch.train import make_optimizer, train_step_fn
from test_torch_clustering import JaxRng
from test_torch_subsample import random_tree

GEOM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_patterns=((1, 8), (2, 8)), covariance_dim=4, beam_size=4, image_size=64,
            patch_size=16)
SENTINEL = 1e6


def _cfgs(**kw):
    g = {**GEOM, **kw}
    return (jsac.SaccadicViTConfig(**g, policy=j_parity()),
            tsac.SaccadicViTConfig(**g, policy=t_parity()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


def _rel(got, want, rel, what=""):
    """Within `rel` of max(1, the largest magnitude of `want`)."""
    _close(got, want, rel * max(1.0, float(np.abs(_np(want)).max(initial=0.0))), what)


def _feats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables():
    """JAX variables of the three modules at the tiny config, drawn into
    the trees of their `init`s (`random_tree`): the bank's means and
    factors and the pattern tokens N(0, 1), as flax draws them, the shift
    0."""
    jcfg, _ = _cfgs()
    d = jcfg.hidden_size
    key = jax.random.PRNGKey(3)
    pattern = jsac.SaccadicViTMultiStatePattern(jcfg)
    h, c = jnp.zeros((1, 1, d)), jnp.zeros((1, 2, d))
    shapes = {
        "embeddings": jax.eval_shape(jsac.SaccadicViTEmbeddings(jcfg).init, key,
                                     jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, jcfg.dof))),
        "pattern": jax.eval_shape(functools.partial(pattern.init, max_wildcards=1), key, h, c),
    }
    matches = jax.eval_shape(functools.partial(pattern.apply, max_wildcards=1),
                             shapes["pattern"], h, c)
    shapes["predictor"] = jax.eval_shape(jsac.TransformerSaccadicViTPredictor(jcfg).init,
                                         key, h, c, matches)
    return random_tree(shapes, 3, {"mean": (0.0, 1.0), "std": (0.0, 1.0),
                                   "cls_tokens": (0.0, 1.0), "log_covariance_shift": (0.0, 0.0)})


def _port_model(**kw):
    _, tcfg = _cfgs(**kw)
    model = tsac.SaccadicViTModel(tcfg)
    model.load_state_dict(saccadic_params_from_jax(_variables()), strict=True)
    return model.eval()


# -------------------------------------------------------------- config ----


def test_config_matches_jax():
    assert tsac.PATCH_CONFIG_DOF == jsac.config.PATCH_CONFIG_DOF
    jf = [(f.name, f.default) for f in dataclasses.fields(jsac.SaccadicViTConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsac.SaccadicViTConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, jd), (_, td) in zip(jf, tf):
        if n == "policy":
            assert dataclasses.asdict(jd) == dataclasses.asdict(td)
        else:
            assert jd == td, n
    _, tcfg = _cfgs(patch_config="non-uniform-scaling")
    assert (tcfg.dof, tcfg.max_complexity, tcfg.num_patterns_dict) == (4, 2, {1: 8, 2: 8})


# ------------------------------------------------------------- log-pdf ----


def _pdf_inputs(batch_mean):
    search = _feats(1, 2, 5, 32)
    mean = _feats(2, batch_mean, 3, 2, 32)
    cov = 0.3 * _feats(3, batch_mean, 3, 2, 32, 4)
    return search, mean, cov, np.float32(0.2)


@pytest.mark.parametrize("batch_mean", [1, 2])
def test_log_pdf_routes_match_jax_and_each_other(batch_mean):
    """Cholesky-Woodbury and eigh routes, each against JAX's (log-pdf
    1e-4 of its largest magnitude; chol's norm_demean and h 1e-4; eigh's
    per-column norms of norm_demean, since LAPACK builds pick other
    eigenvector signs), and against each other in the port: equal log-pdfs,
    |norm_demean| rows and adapters h h^T = (I + G)^-1.  A bank of batch 1
    serves the whole batch."""
    args = _pdf_inputs(batch_mean)
    jc = jax.jit(jpat.gaussian_low_rank_log_pdf_chol)(*args)
    je = jax.jit(jpat.gaussian_low_rank_log_pdf)(*args)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    tc = tpat.gaussian_low_rank_log_pdf_chol(*targs)
    te = tpat.gaussian_low_rank_log_pdf(*targs)
    assert tc[0].shape == (2, 3, 2, 5) and tc[1].shape == (2, 3, 2, 5, 4)
    for got, want, name in zip(tc, jc, ("log_pdf", "norm_demean", "h")):
        _rel(got, want, 1e-4, f"chol {name}")
    _rel(te[0], je[0], 1e-4, "eigh log_pdf")
    _rel(te[1].abs(), np.abs(np.asarray(je[1])), 1e-4, "eigh |norm_demean|")
    _rel(te[2], je[2], 1e-4, "eigh log_l")
    _rel(te[0], tc[0], 1e-4, "chol vs eigh log_pdf")
    _rel(te[1].norm(dim=-1), tc[1].norm(dim=-1), 1e-4, "chol vs eigh |norm_demean|")
    h_eigh = tpat._matcher_solve(*targs, "eigh")[2]
    _rel(h_eigh @ h_eigh.mT, tc[2] @ tc[2].mT, 1e-4, "h h^T")


# --------------------------------------------------------------- match ----


@functools.lru_cache(maxsize=None)
def _jax_match(solver):
    jcfg, _ = _cfgs(matcher_solver=solver)
    pattern = jsac.SaccadicViTMultiStatePattern(jcfg)
    return jax.jit(lambda v, h, c: pattern.apply(v, h, c, 1))


def _match_inputs():
    hidden = _feats(4, 2, 2, 32)
    context = np.concatenate([_feats(5, 2, 3, 32), np.full((2, 3, 32), SENTINEL, np.float32)],
                             axis=1)  # 3 real context nodes, 3 sentinel pads
    return hidden, context


@pytest.mark.parametrize("solver", ["chol", "eigh"])
def test_match_matches_jax(solver):
    """The wildcard-stratified beam search: the same keys in the same
    order, pattern and node indices equal, joint log-pdfs and conditional
    means within 1e-4 of their largest magnitude, the conditional
    covariances (chol) or their products cov cov^T (eigh: eigenvector
    signs) too.  Only real entries are compared: the context carries
    sentinel pads (1e6) whose log-pdfs are differences of ~1e14-sized f32
    sums, noise of other sizes in each package; the beam never binds
    one."""
    hidden, context = _match_inputs()
    jm = _jax_match(solver)(_variables()["pattern"], jnp.asarray(hidden), jnp.asarray(context))
    pattern = _port_model(matcher_solver=solver).pattern
    with torch.no_grad():
        tm = pattern.match(torch.from_numpy(hidden), torch.from_numpy(context), 1)
    # JAX's order; its jitted function returns the keys sorted
    assert list(tm) == [(1, 0), (2, 1), (2, 0)] and sorted(tm) == list(jm)
    for key in tm:
        t, j = tm[key], jm[key]
        assert np.array_equal(t["pattern_index"].numpy(), np.asarray(j["pattern_index"])), key
        nodes = t["node_indices"].numpy()
        assert np.array_equal(nodes, np.asarray(j["node_indices"])), key
        assert nodes.max() < 2 + 3  # never a sentinel (indices >= N + 3)
        _rel(t["joint_log_pdf"], j["joint_log_pdf"], 1e-4, f"{key} joint")
        _rel(t["conditional_mean"], j["conditional_mean"], 1e-4, f"{key} mean")
        tc, jc = t["conditional_covariance"], np.asarray(j["conditional_covariance"])
        if solver == "eigh":
            tc, jc = tc @ tc.mT, jc @ np.swapaxes(jc, -1, -2)
        _rel(tc, jc, 1e-4, f"{key} covariance")


def test_match_chol_equals_eigh_in_the_port():
    """The two decompositions give the same beams: equal indices, joint
    log-pdfs and conditional means within 1e-4, cov cov^T equal."""
    hidden, context = _match_inputs()
    h, c = torch.from_numpy(hidden), torch.from_numpy(context)
    with torch.no_grad():
        mc = _port_model(matcher_solver="chol").pattern.match(h, c, 1)
        me = _port_model(matcher_solver="eigh").pattern.match(h, c, 1)
    for key in mc:
        assert torch.equal(mc[key]["node_indices"], me[key]["node_indices"])
        assert torch.equal(mc[key]["pattern_index"], me[key]["pattern_index"])
        _rel(me[key]["joint_log_pdf"], mc[key]["joint_log_pdf"], 1e-4)
        _rel(me[key]["conditional_mean"], mc[key]["conditional_mean"], 1e-4)
        a, b = mc[key]["conditional_covariance"], me[key]["conditional_covariance"]
        _rel(b @ b.mT, a @ a.mT, 1e-4)


def test_top_k_keeps_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    assert tpat.top_k_indices(x, 3).tolist() == [[1, 2, 4]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]).tolist() == [[1, 2, 4]]


# ------------------------------------------------------------- refiner ----


@pytest.mark.parametrize("attn", ["quadratic", "eager"])
def test_attention_matches_jax(attn):
    """Both refiner attentions under a bool mask with a fully masked row
    (uniform over the keys, as in JAX): within 1e-5 of max(1, |out|)."""
    jcfg, tcfg = _cfgs(refiner_attention=attn)
    jmod = (JQuad if attn == "quadratic" else JEager)(jcfg)
    x = _feats(6, 2, 5, 32)
    mask = np.random.default_rng(7).random((2, 5, 5)) < 0.6
    mask[:, 2] = False
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(8), jnp.asarray(x), jnp.asarray(mask))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(mask))
    tmod = (tsac.QuadraticSelfAttention if attn == "quadratic"
            else tsac.EagerSelfAttention)(tcfg, torch.Generator().manual_seed(0))
    state = {}
    for name, p in variables["params"].items():
        state[f"{name}.weight"] = torch.from_numpy(np.asarray(p["kernel"])).T
        if "bias" in p:
            state[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"]))
    tmod.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    _rel(got, want, 1e-5)


def test_refiner_matches_jax():
    """The predictor over [hidden ++ matched pattern tokens] with the
    block mask: the refined hidden nodes and every pattern key's tokens
    within 1e-4 of their largest magnitude."""
    jcfg, _ = _cfgs()
    hidden, context = _match_inputs()
    v = _variables()
    jm = _jax_match("chol")(v["pattern"], jnp.asarray(hidden), jnp.asarray(context))
    predictor = jsac.TransformerSaccadicViTPredictor(jcfg)
    jh, jout = jax.jit(predictor.apply)(v["predictor"], jnp.asarray(hidden),
                                        jnp.asarray(context), jm)
    model = _port_model()
    with torch.no_grad():
        tm = model.pattern.match(torch.from_numpy(hidden), torch.from_numpy(context), 1)
        th, tout = model.predictor(torch.from_numpy(hidden), torch.from_numpy(context), tm)
    _rel(th, jh, 1e-4, "hidden")
    for key in tout:
        _rel(tout[key], jout[key], 1e-4, str(key))


def test_predicted_states_mean_draws_like_jax():
    """`predicted_states("mean")` with JAX's key (through `JaxRng`): mean
    plus the low-rank and the isotropic noise, within 1e-5."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(9)
    p = {"conditional_mean": rng.standard_normal((2, 3, 1, 32)).astype(np.float32),
         "conditional_covariance": rng.standard_normal((2, 3, 1, 32, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(10)
    want = jsac.TransformerSaccadicViTPredictor(jcfg).apply(
        _variables()["predictor"], {k: jnp.asarray(x) for k, x in p.items()},
        jnp.float32(0.3), "mean", key, method="predicted_states")
    got = _port_model().predictor.predicted_states(
        {k: torch.from_numpy(x) for k, x in p.items()}, torch.tensor(0.3), "mean",
        JaxRng(key))
    _rel(got, want, 1e-5)


# ---------------------------------------------------------- embeddings ----


@pytest.mark.parametrize("patch_config", ["translation", "scaling", "non-uniform-scaling"])
def test_embeddings_match_jax(patch_config):
    """The glimpse lattice (grid_points, axis_coords), the embedding of a
    [B, 2] batch of glimpses (bicubic, zeros padding, some outside the
    image) and decode_position."""
    jcfg, tcfg = _cfgs(patch_config=patch_config)
    jemb = jsac.SaccadicViTEmbeddings(jcfg)
    pix = _feats(11, 2, 64, 64, 3)
    pc = np.random.default_rng(12).uniform(-1.2, 1.2, (2, 2, jcfg.dof)).astype(np.float32)
    pc[..., 2:] *= 0.5
    v = jax.jit(jemb.init)(jax.random.PRNGKey(13), jnp.asarray(pix), jnp.asarray(pc))
    want = jax.jit(jemb.apply)(v, jnp.asarray(pix), jnp.asarray(pc))
    latent = _feats(14, 3, 32)
    want_pos = jemb.apply(v, jnp.asarray(latent), method=jsac.SaccadicViTEmbeddings.decode_position)
    pe = jsac.embeddings.SaccadicViTPatchEmbeddings(jcfg)
    want_pts = pe.grid_points(jnp.asarray(pc))
    want_ax = pe.axis_coords(jnp.asarray(pc))
    temb = tsac.SaccadicViTEmbeddings(tcfg, torch.Generator().manual_seed(0))
    state = saccadic_params_from_jax({"embeddings": v})
    temb.load_state_dict({k[len("embeddings."):]: t for k, t in state.items()}, strict=True)
    with torch.no_grad():
        got = temb(torch.from_numpy(pix), torch.from_numpy(pc))
        got_pos = temb.decode_position(torch.from_numpy(latent))
    tpc = torch.from_numpy(pc)
    _close(temb.patch_embeddings.grid_points(tpc), want_pts, 1e-6, "grid_points")
    for a, b in zip(temb.patch_embeddings.axis_coords(tpc), want_ax):
        _close(a, b, 1e-6, "axis_coords")
    assert got.shape == want.shape == (2, 2, 32)
    _rel(got, want, 1e-4, "embedding")
    _close(got_pos, want_pos, 1e-5, "decode_position")


# ------------------------------------------------------------- the runs ----


def test_batched_run_matches_jax():
    """4 lockstep steps over 3 images: embeddings, predicted embeddings
    and queries within 1e-4 of their largest magnitude, converged and
    num_saccades equal."""
    jcfg, _ = _cfgs()
    v = _variables()
    pix = _feats(15, 3, 64, 64, 3)
    run = jax.jit(lambda v, x: j_batched(jcfg, v, x, num_steps=4, max_saccade_length=3))
    want = run({"embeddings": v["embeddings"], "pattern": v["pattern"]}, jnp.asarray(pix))
    model = _port_model()
    got = tsac.batched_saccade_run(model.embeddings, model.pattern, torch.from_numpy(pix),
                                   num_steps=4, max_saccade_length=3)
    for k in ("embeddings", "predicted", "queries"):
        assert got[k].shape == want[k].shape, k
        _rel(got[k], want[k], 1e-4, k)
    assert np.array_equal(got["converged"].numpy(), np.asarray(want["converged"]))
    assert np.array_equal(got["num_saccades"].numpy(), np.asarray(want["num_saccades"]))
    assert int(got["num_saccades"].sum()) > 0


def test_serial_controller_trace_matches_jax():
    """The serial controller on one image (at most 8 steps, saccades of at
    most 3): the step count, the terminal indices, the constructed edges
    (complexity, pattern, bound nodes; joint log-pdf 1e-4 relative) and the
    last step's proposals equal; the trace's queries and embeddings within
    1e-4 of their largest magnitude."""
    jcfg, _ = _cfgs()
    pix = _feats(16, 1, 64, 64, 3)
    kw = dict(max_trace_length=8, max_saccade_length=3)
    want = jsac.SaccadicViTModel(jcfg).forward(_variables(), jnp.asarray(pix), **kw)
    got = _port_model()(torch.from_numpy(pix), **kw)
    assert got["num_steps"] == want["num_steps"] >= 4
    assert got["terminal_indices"] == want["terminal_indices"]
    assert len(got["constructed_edges"]) == len(want["constructed_edges"])
    for a, b in zip(got["constructed_edges"] + [e for e, _ in got["proposed_edges"]],
                    want["constructed_edges"] + [e for e, _ in want["proposed_edges"]]):
        assert (a.complexity, a.pattern_index) == (b.complexity, b.pattern_index)
        assert np.array_equal(a.node_indices, b.node_indices)
        assert abs(a.joint_log_pdf - b.joint_log_pdf) <= 1e-4 * max(1.0, abs(b.joint_log_pdf))
    for k in ("query", "embedding", "raw_embedding", "predicted_embedding"):
        _rel(got["trace"][k], want["trace"][k], 1e-4, k)
    jt = jl.trace_losses(want["trace"], _variables()["embeddings"],
                         jsac.SaccadicViTEmbeddings(jcfg))
    tt = tsac.trace_losses(got["trace"], _port_model().embeddings)
    for k in jt:
        assert abs(tt[k] - jt[k]) <= 1e-4 * max(1.0, abs(jt[k])), k


# -------------------------------------------------------------- losses ----


def _pools():
    return _feats(17, 3, 4, 32), _feats(18, 3, 2, 32)


def _jax_objective(params, hidden, context):
    jcfg, _ = _cfgs()
    pattern = jsac.SaccadicViTMultiStatePattern(jcfg)
    predictor = jsac.TransformerSaccadicViTPredictor(jcfg)
    nll = jl.pattern_nll_loss(pattern, params["pattern"], hidden, context)
    pres, aux = jl.refiner_preservation_loss(pattern, predictor, params["pattern"],
                                             params["refiner"], hidden, context)
    return nll + pres, (nll, pres, aux["best_joint_log_pdf"])


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    return jax.jit(jax.value_and_grad(_jax_objective, has_aux=True))


def _port_trained():
    model = _port_model()
    trained = torch.nn.Module()
    trained.pattern, trained.refiner = model.pattern, model.predictor
    return trained.train()


def test_losses_and_gradients_match_jax():
    """pattern_nll_loss, refiner_preservation_loss (and its aux) and their
    sum's gradients for every pattern and refiner parameter against
    `jax.grad`, within 1e-4 of max(1, the largest magnitude)."""
    hidden, context = _pools()
    v = _variables()
    params = {"pattern": v["pattern"], "refiner": v["predictor"]}
    (jval, (jnll, jpres, jbest)), jg = _jax_value_and_grad()(
        params, jnp.asarray(hidden), jnp.asarray(context))
    trained = _port_trained()
    loss, parts = ex.objective(trained, torch.from_numpy(hidden), torch.from_numpy(context))
    loss.backward()
    _rel(parts["nll"], jnll, 1e-4, "nll")
    _rel(parts["preservation"], jpres, 1e-4, "preservation")
    _rel(parts["best_joint_log_pdf"], jbest, 1e-4, "best_joint_log_pdf")
    _rel(loss, jval, 1e-4, "total")
    want = saccadic_params_from_jax({"pattern": jg["pattern"], "predictor": jg["refiner"]})
    named = {f"pattern.{n}": p for n, p in trained.pattern.named_parameters()}
    named.update({f"predictor.{n}": p for n, p in trained.refiner.named_parameters()})
    assert set(named) == set(want)
    for n, p in named.items():
        _rel(p.grad, want[n], 1e-4, n)


def test_three_adamw_steps_match_optax():
    """Three steps of `train_saccadic`'s objective: the port's AdamW (at
    optax's `adamw(lr)` defaults) against optax on the same pools, the
    losses within 1e-4 relative and every parameter within 1e-5 after each
    step, but for the elements whose JAX gradient was nonzero and below
    1e-7 in some step (a few percent): there the gradient is f32 roundoff (a key bias's is zero in exact
    arithmetic: it shifts a whole score row), and Adam's g / (|g| + 1e-8)
    turns roundoff into a share of a step, so those are held to the bound of
    three steps, 3 lr."""
    hidden, context = _pools()
    v = _variables()
    params = {"pattern": v["pattern"], "refiner": v["predictor"]}
    lr = 1e-3
    opt = optax.adamw(lr)
    jstate = opt.init(params)

    @jax.jit
    def apply(g, state, params):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state

    def jstep(params, state):
        (loss, _), g = _jax_value_and_grad()(params, jnp.asarray(hidden), jnp.asarray(context))
        return (*apply(g, state, params), loss, g)

    trained = _port_trained()
    named = {f"pattern.{n}": p for n, p in trained.pattern.named_parameters()}
    named.update({f"predictor.{n}": p for n, p in trained.refiner.named_parameters()})
    optimizer = make_optimizer(lr, weight_decay=1e-4)
    step = train_step_fn(lambda m, batch, g: ex.objective(m, *batch), optimizer)
    state = optimizer.init(trained)
    batch = (torch.from_numpy(hidden), torch.from_numpy(context))
    noise = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in named.items()}
    for _ in range(3):
        params, jstate, jloss, jg = jstep(params, jstate)
        grads = saccadic_params_from_jax({"pattern": jg["pattern"], "predictor": jg["refiner"]})
        loss, _ = step(trained, state, batch, None)
        _rel(loss, jloss, 1e-4, "loss")
        want = saccadic_params_from_jax({"pattern": params["pattern"],
                                         "predictor": params["refiner"]})
        for n, p in named.items():
            noise[n] |= (grads[n] != 0) & (grads[n].abs() < 1e-7)
            diff = (p.detach() - want[n]).abs()
            assert float(torch.where(noise[n], 0.0, diff).max()) <= 1e-5, n
            assert float(torch.where(noise[n], diff, 0.0).max()) <= 3 * lr, n
    assert sum(int(m.sum()) for m in noise.values()) < 0.05 * sum(
        m.numel() for m in noise.values())


# ------------------------------------------------------------ examples ----


def test_examples_cli_on_the_cpu():
    """Both examples on `--device cpu` at the tiny config: the demo's three
    parts; `train_saccadic` for 2 steps with finite losses (`--dataset` is
    ported: `tests/test_torch_runtime_examples.py` runs it on an image
    folder); without a card `--device cuda` raises."""
    _, tcfg = _cfgs()
    out = demo.main(["--device", "cpu"], config=tcfg)
    assert out["embedding_shape"] == (1, 32)
    assert set(out["best_joint_log_pdf"]) == {(1, 0), (2, 1), (2, 0)}
    assert 1 <= out["num_steps"] <= 8
    res = ex.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--glimpses", "4",
                   "--context", "2"], config=tcfg)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["hidden"] == (2, 2, 32) and res["context"] == (2, 2, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.main(["--steps", "1"], config=tcfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main([], config=tcfg)
