"""Export: serialize a forward to a portable artifact and reload it with no
model code (counterpart of `msvit_tpu/export.py`): a training host exports
the forward once, serving hosts `load_forward` the artifact and run it,
never importing `msvit_tpu_torch.models`.

* Built on `torch.export`: the artifact holds the traced graph of
  ``fn(params, *args)`` (ATen ops and the port's registered kernel ops,
  `torch.ops.msvit.packed_attention` (K1) and
  `torch.ops.msvit.packed_attention_int8` (K3)), serialized with
  `torch.export.save`.  Reloading needs the op registrations, which
  `load_forward` imports (`msvit_tpu_torch.ops.packed_attention`); the
  reloaded graph calls the same kernels as the live model.
* The trace runs under `torch.no_grad()`, so `packed_attention` takes its
  inference branch (K1, the shaved softmax), not the autograd Function.
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

An artifact is a zip: ``meta.json`` (platforms, param key paths, bundling)
and one ``program_<platform>.pt2`` per platform.  No CUDA graph is taken.
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

from msvit_tpu_torch.ops import packed_attention  # noqa: F401  (registers torch.ops.msvit)

FORMAT = 1


def _register_flop_formulas() -> None:
    """FLOPs of the registered kernel ops and of `torch._int_mm` (which the
    counter lacks), so that an int8 forward is counted in full: 2 M K N per
    GEMM, 4 B N^2 D per attention (QK^T and PV)."""
    def attention(qkv_shape, *args, out_shape=None, **kwargs) -> int:
        b, n, d3 = qkv_shape
        return 4 * b * n * n * (d3 // 3)

    def int_mm(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        m, k = a_shape
        return 2 * m * k * b_shape[1]

    for op, formula in ((torch.ops.msvit.packed_attention, attention),
                        (torch.ops.msvit.packed_attention_int8, attention),
                        (torch.ops.aten._int_mm, int_mm)):
        if op not in flop_registry:
            register_flop_formula(op)(formula)


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
    meta = {"format": FORMAT, "platforms": kinds, "bundle_params": bool(bundle_params),
            "param_paths": [] if bundle_params else paths}
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        for kind in kinds:
            dev = torch.device(kind)
            ep = _export(fn, _to(params, dev), _to(args, dev), bundle_params, batch)
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"program_{kind}.pt2", buf.getvalue())
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
