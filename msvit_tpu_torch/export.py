"""Export: serialize a forward to a portable artifact and reload it with no
model code (counterpart of `msvit_tpu/export.py`): a training host exports
the forward once, serving hosts `load_forward` the artifact and run it,
never importing `msvit_tpu_torch.models`.

* Built on `torch.export`: the artifact holds the traced graph of
  ``fn(params, *args)`` (ATen ops and the port's registered kernel ops,
  `torch.ops.msvit.*`: K1 `packed_attention`, K3 `packed_attention_int8`,
  K9 `packed_attention_int8_masked`, K5 `fused_attention`, K4
  `fused_attention_inference`, K7 `flash_attention`, K10 `token_rows`),
  serialized with `torch.export.save`.  Reloading needs the op
  registrations, which this module imports (`msvit_tpu_torch.ops`' four
  attention modules, none of the models); the reloaded graph calls the
  same kernels as the live model.
* The trace runs under `torch.no_grad()`, so each attention wrapper takes
  its inference branch (K1, K5, K7, K10), not its autograd Function.
* Clustering draws (`utils/rng.py`) are counter-based hashes of a seed
  that the forward closes over: the seed is fixed at export (as a JAX
  forward that closes over its key) and the graph draws at the traced
  size, B x N tokens under a symbolic batch.  Per-image clustering
  (`pool_batch=False`) loops over the batch in Python and exports at a
  fixed batch only: under `polymorphic_batch=True` it raises a
  `ValueError`.
* Params ride outside the artifact (the default: `params` is any pytree of
  tensors, dicts and NamedTuples such as the int8 `QuantizedTensor`, passed
  at every call and checked against the exported key paths) or inside it
  (`bundle_params=True`: the exported callable takes the other arguments).
* `polymorphic_batch=True` gives every data argument a symbolic leading
  axis "b" (min 1): one artifact serves every batch size, the
  `serve.BatchingServer` bucket ladder.  `torch.export` specializes an axis
  whose example size is 0 or 1, so the example batch must be 2 or more.
* `platforms`: one exported program per device type ("cuda", "cpu") in the
  artifact, each traced on that device (the device of the examples by
  default); `load_forward` runs the one that matches the inputs' device.
  A trace bakes device-side constants (a normalization's mean and std, the
  int8 GEMM's row padding) for its device, hence one program per device.

An artifact is a zip: ``meta.json`` (platforms, param key paths, bundling,
each program's count of op nodes, ``graph_nodes``: a reloaded graph runs
them one by one in Python) and one ``program_<platform>.pt2`` per
platform.  No CUDA graph is taken.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.export import Dim
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula

# registers torch.ops.msvit.*
from msvit_tpu_torch.ops import banded_attention, flash_attention  # noqa: F401
from msvit_tpu_torch.ops import fused_attention, packed_attention  # noqa: F401

FORMAT = 1


def _register_flop_formulas() -> None:
    """FLOPs of the registered kernel ops and of `torch._int_mm` (which the
    counter lacks), so that an int8 or a clustered forward is counted in
    full: 2 M K N per GEMM, 4 B H Nq Nk dh per attention (QK^T and PV); K10
    counts the query-key pairs of its partition (each token's own cluster
    and its RX key), the work the data needs."""
    def attention(qkv_shape, *args, out_shape=None, **kwargs) -> int:
        b, n, d3 = qkv_shape
        return 4 * b * n * n * (d3 // 3)

    def attention_heads(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
        b, h, nq, dh = q_shape
        return 4 * b * h * nq * k_shape[2] * dh

    def token_rows(qkv, cid, num_heads, max_clusters, *args, out_val=None, **kwargs) -> int:
        sizes = torch.nn.functional.one_hot(cid.long(), max_clusters).sum(1).double()
        pairs = (sizes * sizes).sum() + cid.numel()
        return int(4 * (qkv.shape[-1] // 3) * pairs.item())

    def int_mm(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        m, k = a_shape
        return 2 * m * k * b_shape[1]

    ops = torch.ops.msvit
    for op, formula, raw in ((ops.packed_attention, attention, False),
                             (ops.packed_attention_int8, attention, False),
                             (ops.packed_attention_int8_masked, attention, False),
                             (ops.fused_attention, attention_heads, False),
                             (ops.fused_attention_inference, attention_heads, False),
                             (ops.flash_attention, attention_heads, False),
                             (ops.token_rows, token_rows, True),
                             (torch.ops.aten._int_mm, int_mm, False)):
        if op not in flop_registry:
            register_flop_formula(op, get_raw=raw)(formula)


_register_flop_formulas()


def _flatten(params: Any) -> Tuple[List[torch.Tensor], List[str], Any]:
    flat, spec = pytree.tree_flatten_with_path(params)
    return [leaf for _, leaf in flat], [pytree.keystr(kp) for kp, _ in flat], spec


class _ParamLeaves:
    """Flattens a call's params and checks them against the exported key
    paths.  Forming the paths (a string per leaf, by walking the tree with
    its keys) costs several times a plain flatten, so they are formed only
    for a tree structure not seen before; after that the check is a
    comparison of tree specs."""

    def __init__(self, paths: List[str]):
        self.paths, self.spec = paths, None

    def __call__(self, params: Any) -> List[torch.Tensor]:
        leaves, spec = pytree.tree_flatten(params)
        if self.spec is None or spec != self.spec:
            paths = _flatten(params)[1]
            if paths != self.paths:
                raise ValueError("params do not match the exported ones (key paths "
                                 f"{paths[:3]}... vs {self.paths[:3]}...)")
            self.spec = spec
        return leaves


class _Forward(nn.Module):
    """``fn(params, *args)`` over flat param leaves, for `torch.export`:
    forward(leaves, args).  Bundled params are buffers of the module (and
    so weights of the exported program); `leaves` is then empty."""

    def __init__(self, fn: Callable[..., Any], spec: Any,
                 bundled: Optional[List[torch.Tensor]] = None):
        super().__init__()
        self.fn, self.spec = fn, spec
        self.n_bundled = 0 if bundled is None else len(bundled)
        for i, t in enumerate(bundled or ()):
            self.register_buffer(f"p{i}", t)

    def forward(self, leaves: List[torch.Tensor], args: Tuple[Any, ...]):
        if self.n_bundled:
            leaves = [getattr(self, f"p{i}") for i in range(self.n_bundled)]
        return self.fn(pytree.tree_unflatten(leaves, self.spec), *args)


def _to(tree: Any, device: torch.device) -> Any:
    return pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def _device_type(tree: Any) -> str:
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device.type
    raise ValueError("no tensor among the data arguments")


def _export(fn, params, args, bundle: bool, batch: Optional[Dim]) -> torch.export.ExportedProgram:
    leaves, _, spec = _flatten(params)
    module = _Forward(fn, spec, leaves if bundle else None)
    inputs = [] if bundle else leaves
    data_dims = pytree.tree_map(
        lambda x: {0: batch} if batch is not None and x.ndim > 0 else None, args)
    with torch.no_grad():
        ep = torch.export.export(module, (inputs, tuple(args)),
                                 dynamic_shapes=([None] * len(inputs), data_dims))
    ep.example_inputs = None  # else the params are saved as sample inputs
    return ep


def export_forward(
    fn: Callable[..., Any],
    example_args: Tuple[Any, ...],
    *,
    platforms: Optional[Sequence[str]] = None,
    bundle_params: bool = False,
    polymorphic_batch: bool = False,
) -> bytes:
    """Serialize ``fn(params, *args)`` to an artifact (bytes).

    `example_args` is ``(params, *args)``: real tensors (they are traced;
    the params are saved only with `bundle_params`, and the exported
    callable then takes the remaining args).  `platforms` (device types,
    default the examples') gives one program per device type, each traced
    on its device.  `polymorphic_batch` exports a symbolic leading axis on
    the data args (the params keep their shapes)."""
    params, args = example_args[0], tuple(example_args[1:])
    kinds = list(platforms) if platforms else [_device_type(args)]
    batch = Dim("b", min=1) if polymorphic_batch else None
    _, paths, _ = _flatten(params)
    programs, nodes = {}, {}
    for kind in kinds:
        dev = torch.device(kind)
        ep = _export(fn, _to(params, dev), _to(args, dev), bundle_params, batch)
        nodes[kind] = sum(1 for n in ep.graph.nodes if n.op == "call_function")
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[kind] = buf.getvalue()
    meta = {"format": FORMAT, "platforms": kinds, "bundle_params": bool(bundle_params),
            "param_paths": [] if bundle_params else paths, "graph_nodes": nodes}
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        for kind, program in programs.items():
            z.writestr(f"program_{kind}.pt2", program)
    return out.getvalue()


class LoadedForward:
    """A reloaded artifact: ``g(params, *args)``, or ``g(*args)`` for
    bundled params.  Runs the program of the data args' device type (each
    loaded on its first call); raises for a device type the artifact does
    not hold, and for params whose key paths differ from the exported
    ones."""

    def __init__(self, meta: Dict[str, Any], programs: Dict[str, bytes]):
        self.meta = meta
        self._serialized = programs
        self._modules: Dict[str, Callable[..., Any]] = {}
        self._leaves = _ParamLeaves(meta["param_paths"])

    def _module(self, kind: str):
        if kind not in self._modules:
            if kind not in self._serialized:
                raise ValueError(f"the artifact holds programs for {self.meta['platforms']}, "
                                 f"not for {kind!r} tensors")
            ep = torch.export.load(io.BytesIO(self._serialized[kind]))
            self._modules[kind] = ep.module()
        return self._modules[kind]

    def __call__(self, *call_args: Any) -> Any:
        if self.meta["bundle_params"]:
            leaves, args = [], call_args
        else:
            leaves, args = self._leaves(call_args[0]), call_args[1:]
        with torch.no_grad():
            return self._module(_device_type(args))(leaves, tuple(args))


def load_forward(artifact: bytes) -> LoadedForward:
    """Rehydrate an artifact into a callable.  Imports the port's op
    registrations (`msvit_tpu_torch.ops`) and nothing of its models."""
    with zipfile.ZipFile(io.BytesIO(artifact)) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(f"artifact format {meta.get('format')!r}, want {FORMAT}")
        programs = {k: z.read(f"program_{k}.pt2") for k in meta["platforms"]}
    return LoadedForward(meta, programs)


def aot_compile(
    fn: Callable[..., Any], example_args: Tuple[Any, ...]
) -> Tuple[Callable[..., Any], dict]:
    """Ahead of time, in this process: the forward exported at the example
    shapes, as a callable ``g(params, *args)`` (the graph runs; no Python
    model code does), and its cost ({"flops": ...}), counted by
    `FlopCounterMode` over one run of the graph on the examples (the
    kernel ops and `torch._int_mm` included)."""
    params, args = example_args[0], tuple(example_args[1:])
    ep = _export(fn, params, args, bundle=False, batch=None)
    module, flat = ep.module(), _ParamLeaves(_flatten(params)[1])

    def compiled(p: Any, *a: Any) -> Any:
        with torch.no_grad():
            return module(flat(p), tuple(a))

    counter = FlopCounterMode(display=False)
    with counter:
        compiled(params, *args)
    return compiled, {"flops": float(counter.get_total_flops())}
