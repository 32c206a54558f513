"""The port's export (`msvit_tpu_torch/export.py`) on the CPU, at the tiny
config of the JAX package's `tests/test_export.py` (64 wide, 2 layers,
32 px, parity policy): the round trip through bytes equals the port's live
model exactly and stays within 1e-3 of JAX's forward; bundled params; a
polymorphic batch at b = 1, 2 and 5; `aot_compile`'s output and FLOPs; the
int8 artifact (K3 in the graph) against the live int8 apply and JAX's
`quantized_vit_apply`; the reload in a fresh process that imports no model
code; the registered ops' fake implementations against the real ones.

The live references run under `torch.no_grad()`: the export traces the
inference branch of `packed_attention` (K1), where a forward under
autograd takes the exact-softmax Function instead.
"""

import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msvit_tpu.models.base import BaseViTConfig as JCfg
from msvit_tpu.models.base import quantized as jqz
from msvit_tpu.models.base.vit import ViTModel as JViT
from msvit_tpu.settings import parity_policy as j_parity
from msvit_tpu_torch.compat import vit_params_from_jax
from msvit_tpu_torch.export import aot_compile, export_forward, load_forward
from msvit_tpu_torch.models.base import BaseViTConfig as TCfg
from msvit_tpu_torch.models.base import ViTModel as TViT
from msvit_tpu_torch.models.base import quantized as tqz
from msvit_tpu_torch.settings import parity_policy as t_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=32,
            patch_size=16)
TOKENS = 5  # 4 patches + CLS


@pytest.fixture(scope="module")
def tiny():
    """JAX params of the tiny config and the port's model loaded with them,
    the port's forward fn(params, x) and its params, and the pixels."""
    jcfg = JCfg(**TINY, policy=j_parity(), attn_implementation="xla")
    tcfg = TCfg(**TINY, policy=t_parity())
    pix = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jparams = JViT(jcfg).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pix))
    model = TViT(tcfg)
    model.load_state_dict(vit_params_from_jax(jparams, tcfg), strict=True)
    model.eval()

    def fwd(p, x):
        return torch.func.functional_call(model, p, (x,))["last_hidden_state"]

    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, model=model, fwd=fwd,
                params=dict(model.named_parameters()), pix=torch.from_numpy(pix))


def _live(fn, *args):
    with torch.no_grad():
        return fn(*args)


def _graph_ops(artifact: bytes, platform: str = "cpu") -> list:
    with zipfile.ZipFile(io.BytesIO(artifact)) as z:
        ep = torch.export.load(io.BytesIO(z.read(f"program_{platform}.pt2")))
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def _batch(b: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(b).standard_normal((b, 32, 32, 3)).astype(np.float32))


def test_roundtrip_matches_live_model_and_jax(tiny, tmp_path):
    """Params outside the artifact, through a file: equal to the live model
    element for element, within 1e-3 of JAX's forward; the graph calls K1
    (the registered op, the inference branch) once per layer, though the
    params require grad."""
    fwd, params, pix = tiny["fwd"], tiny["params"], tiny["pix"]
    assert all(p.requires_grad for p in params.values())
    art = export_forward(fwd, (params, pix))
    assert isinstance(art, bytes) and len(art) > 0
    f = tmp_path / "vit.msvx"
    f.write_bytes(art)
    g = load_forward(f.read_bytes())
    got = g(params, pix)
    assert torch.equal(got, _live(fwd, params, pix))
    want = JViT(tiny["jcfg"]).apply(tiny["jparams"], jnp.asarray(pix.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want["last_hidden_state"]),
                               atol=1e-3, rtol=0)
    ops = _graph_ops(art)
    assert ops.count("msvit.packed_attention.default") == 2


@pytest.fixture(scope="module")
def bf16_poly(tiny):
    """The bf16 forward exported with a polymorphic batch."""
    return export_forward(tiny["fwd"], (tiny["params"], tiny["pix"]), polymorphic_batch=True)


def test_bundled_params(tiny, bf16_poly):
    """Params frozen inside: the callable takes the pixels only; the
    artifact carries the weights (larger by at least their bytes than the
    same export with the params outside)."""
    fwd, params, pix = tiny["fwd"], tiny["params"], tiny["pix"]
    art = export_forward(fwd, (params, pix), bundle_params=True, polymorphic_batch=True)
    for b in (1, 2):
        x = _batch(b)
        assert torch.equal(load_forward(art)(x), _live(fwd, params, x))
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    assert len(art) - len(bf16_poly) >= nbytes


def test_polymorphic_batch(tiny, bf16_poly):
    """One artifact, a symbolic batch axis (exported from a batch of 2):
    equal to the live model at b = 1, 2 and 5."""
    fwd, params = tiny["fwd"], tiny["params"]
    g = load_forward(bf16_poly)
    for b in (1, 2, 5):
        x = _batch(b)
        got = g(params, x)
        assert got.shape == (b, TOKENS, 64)
        assert torch.equal(got, _live(fwd, params, x))


def _analytic_flops(b: int, layers: int = 2, d: int = 64, n: int = TOKENS) -> float:
    """GEMMs (patch projection; qkv, proj, fc1, fc2 per layer) at 2 M K N,
    plus 4 B N^2 D per attention."""
    m = b * n
    gemms = 2 * b * (n - 1) * (16 * 16 * 3) * d + layers * (
        2 * m * d * 3 * d + 2 * m * d * d + 2 * 2 * m * d * 4 * d)
    return float(gemms + layers * 4 * b * n * n * d)


def test_aot_compile_output_and_flops(tiny):
    """The exported graph at the example shapes equals the live model; its
    FLOPs by `FlopCounterMode` equal the analytic count."""
    fwd, params, pix = tiny["fwd"], tiny["params"], tiny["pix"]
    compiled, cost = aot_compile(fwd, (params, pix))
    assert torch.equal(compiled(params, pix), _live(fwd, params, pix))
    assert cost["flops"] == _analytic_flops(2)


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """Both packages' int8 weights and one set of scales (calibrated by the
    port with kernels off; the JAX side takes the same numbers)."""
    jq = jqz.quantize_vit_params(tiny["jparams"]["params"])
    tq = tqz.quantize_vit_params(tiny["model"])
    tcfg = tiny["tcfg"]
    ts = tqz.calibrate_act_scales(tq, tcfg, tiny["pix"], use_kernels=False)
    js = {k: jnp.asarray(v.numpy()) for k, v in ts.items()}

    def fwd(p, x):
        return tqz.quantized_vit_apply(p["weights"], tcfg, x, act_scales=p["scales"],
                                       use_kernels=True)

    params = {"weights": tq, "scales": ts}
    return dict(jq=jq, js=js, fwd=fwd, params=params,
                artifact=export_forward(fwd, (params, tiny["pix"]), polymorphic_batch=True))


def test_int8_artifact(tiny, tiny_int8):
    """The int8 forward (K3, the fully-int8 attention) exported with a
    polymorphic batch and its `QuantizedTensor` params outside: equal to
    the live int8 apply at b = 1, 2 and 5; against JAX's
    `quantized_vit_apply` (kernels in interpret mode) the int8 bar of
    `tests/test_torch_vit.py`, cosine >= 0.999; the graph holds K3 once per
    layer and the int8 GEMMs; the FLOPs count them."""
    fwd, params, art = tiny_int8["fwd"], tiny_int8["params"], tiny_int8["artifact"]
    ops = _graph_ops(art)
    assert ops.count("msvit.packed_attention_int8.default") == 2
    assert ops.count("aten._int_mm.default") == 1 + 2 * 4  # patch; qkv, proj, fc1, fc2
    g = load_forward(art)
    for b in (1, 2, 5):
        x = _batch(b)
        got = g(params, x)
        assert got.dtype == torch.bfloat16 and got.shape == (b, TOKENS, 64)
        assert torch.equal(got, fwd(params, x))
    want = np.asarray(jqz.quantized_vit_apply(
        tiny_int8["jq"], tiny["jcfg"], jnp.asarray(_batch(5).numpy()),
        act_scales=tiny_int8["js"], use_kernels=True), np.float32)
    a, b_ = got.float().numpy().ravel(), want.ravel()
    assert float(a @ b_ / (np.linalg.norm(a) * np.linalg.norm(b_))) >= 0.999
    _, cost = aot_compile(fwd, (params, tiny["pix"]))
    assert cost["flops"] == _analytic_flops(2)


def test_platforms_and_params_are_checked(tiny):
    """An artifact for the CPU refuses tensors of another device type; params
    whose key paths differ from the exported ones are refused."""
    fwd, params, pix = tiny["fwd"], tiny["params"], tiny["pix"]
    g = load_forward(export_forward(fwd, (params, pix), platforms=("cpu",)))
    assert g.meta["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="not for 'meta'"):
        g(params, pix.to("meta"))
    with pytest.raises(ValueError, match="do not match"):
        g({k: v for k, v in list(params.items())[1:]}, pix)


_CHILD = r"""
import sys
import torch
from msvit_tpu_torch.export import load_forward
state = torch.load(sys.argv[1], weights_only=False)  # written by the test
out = {}
for name in ("bf16", "int8"):
    g = load_forward(state[name + "_art"])
    out[name] = g(state[name + "_params"], state["x"])
bad = [m for m in sys.modules if m.startswith("msvit_tpu_torch.models") or m == "jax"
       or m.startswith("msvit_tpu.")]
assert not bad, bad
torch.save(out, sys.argv[2])
print("ok", sorted(m for m in sys.modules if m.startswith("msvit_tpu_torch")))
"""


def test_reload_in_a_fresh_process_without_model_code(tiny, tiny_int8, bf16_poly, tmp_path):
    """A child process that imports only `msvit_tpu_torch.export` reloads the
    bf16 and int8 artifacts and runs them (b = 3): equal to the live models
    here, and no `msvit_tpu_torch.models` (nor JAX) in its `sys.modules`."""
    x = _batch(3)
    qp = tiny_int8["params"]
    state = {
        "bf16_art": bf16_poly, "int8_art": tiny_int8["artifact"],
        "bf16_params": {k: v.detach() for k, v in tiny["params"].items()},
        "int8_params": qp, "x": x,
    }
    torch.save(state, tmp_path / "in.pt")
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path / "in.pt"),
                          str(tmp_path / "out.pt")], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "msvit_tpu_torch.models" not in res.stdout
    out = torch.load(tmp_path / "out.pt", weights_only=True)
    assert torch.equal(out["bf16"], _live(tiny["fwd"], tiny["params"], x))
    assert torch.equal(out["int8"], tiny_int8["fwd"](qp, x))


@pytest.mark.parametrize("masked", [False, True])
def test_fake_implementations_agree_with_real(masked):
    """`torch.library.opcheck` on K1's and K3's registered ops (schema, fake
    implementation against the real one, dispatch under a trace), and the
    fake outputs' shapes and dtypes against the real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 7, 48)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 1, 7, 7)) > 0.3) if masked else None
    qkv_q = torch.from_numpy(rng.integers(-127, 128, (2, 7, 48)).astype(np.int8))
    sec = torch.tensor([0.01, 0.02, 0.03])
    cases = [(torch.ops.msvit.packed_attention.default, (qkv, mask, 4, 0.35, -1e9)),
             (torch.ops.msvit.packed_attention.default, (qkv.bfloat16(), mask, 2, 0.25, -1e9))]
    for int8_out in (False, True):
        inv = torch.tensor(40.0) if int8_out else None
        cases.append((torch.ops.msvit.packed_attention_int8.default,
                      (qkv_q, sec, inv, 4, 0.25, int8_out)))
    for op, args in cases:
        torch.library.opcheck(op, args)
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args])
        assert fake.shape == real.shape and fake.dtype == real.dtype
