"""K3's and K9's int8 wgmma kernel against variants of itself with one part
taken out, on one CUDA card, in one process: where its time goes.

    python3 tools/int8_variants_ab.py    # from the repo root, on a machine with a card

Each variant is `csrc/packed_attention_int8.cu` built alone (one `nvcc`
each, all started together) from a copy of `msvit_tpu_torch/csrc` with
textual patches of `attention_int8_wgmma.cuh` (`VARIANTS`), into a
temporary directory, and called through its C entry points:
* "no_quantize": walk 2 skips the f32 chain per score (multiply,
  subtract, expf, truncating cast, row sums): P.V multiplies the raw
  scores' low bytes;
* "nq_no_transpose": that, and V^T is not written (P.V reads stale bytes);
* "nq_no_walk1": that, and walk 1 is gone (no K loads, no products, no
  max);
* "nq_no_epilogue_math": "no_quantize", and the epilogue stores the raw
  sums' bits (no conversion, division or rounding).
Only "base" computes the function; the others time what is left.  K3 at
[64,197,2304] and K9 at [8,816,2304] with the soft mask of a random
16-cluster partition, int8 out: each kernel alone (`chip_smoke.device_ms`,
10 calls a profile), the variants in turns forward then backward (base
first and last).  Prints one line, "VARIANTS " and a JSON object.
"""
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from msvit_tpu_torch.ops import _build  # noqa: E402

_HEADER = "attention_int8_wgmma.cuh"
_NO_QUANTIZE = [
    ("int8_quantize_tile<MASKED, KIND, true>(sc,",
     "if (false) int8_quantize_tile<MASKED, KIND, true>(sc,"),
    ("int8_quantize_tile<MASKED, KIND, false>(sc,",
     "if (false) int8_quantize_tile<MASKED, KIND, false>(sc,"),
]
VARIANTS = {
    "base": [],
    "no_quantize": _NO_QUANTIZE,
    "nq_no_transpose": _NO_QUANTIZE + [
        ("int8_transpose_v(vts + sv * T, vs + sv * T, threadIdx.x - 288);", "")],
    "nq_no_walk1": _NO_QUANTIZE + [
        ("for (int u = 0; u < 2 * tiles; ++u, ++gk) {",
         "for (int u = tiles; u < 2 * tiles; ++u, ++gk) {"),
        ("    for (int t = 0; t < tiles; ++t) {\n      wait_k(t);",
         "    for (int t = 0; t < 0; ++t) {\n      wait_k(t);"),
        ("    gk += tiles;\n", "\n")],
    "nq_no_epilogue_math": _NO_QUANTIZE + [
        ("v[u] = MASKED ? static_cast<float>(x) * f : static_cast<float>(x) * kv / lr;",
         "v[u] = __int_as_float(x);")],
}
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def build_all(tmp: str) -> dict:
    """{variant: its library}: each patched copy's int8 source compiled
    alone into a shared library, all compiles at once."""
    procs = {}
    for name, patches in VARIANTS.items():
        src = Path(tmp) / name
        shutil.copytree(_build.CSRC, src)
        header = src / _HEADER
        text = header.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: a patch does not apply: {old[:60]!r}")
            text = text.replace(old, new)
        header.write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-shared", "-I", str(src), "-o", str(src / "lib.so"),
               str(src / "packed_attention_int8.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: the build failed:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        lib.msvit_packed_attention_int8.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
        lib.msvit_packed_attention_int8_masked.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL, _F, _F, _P]
        libs[name] = lib
    return libs


def main() -> None:
    smi = c.card()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(23)
    _, q3, s3 = c.int8_qkv(g, c.MAIN_SHAPE, dev, scale=0.5)
    b, h, n, _ = c.MS_SHAPE
    _, q9, s9 = c.int8_qkv(g, (b, n, 3 * h * 64), dev)
    ids = torch.randint(0, c.MS_CLUSTERS, (b, n - 2 * c.MS_CLUSTERS), generator=g)
    soft = c._soft(ids.to(dev), c.MS_CLUSTERS).to(torch.bfloat16).contiguous()
    inv = torch.tensor([20.0], device=dev)
    sc3, sc9 = torch.cat([s3, inv]), torch.cat([s9, inv])
    o3 = torch.empty(*c.MAIN_SHAPE[:2], c.MAIN_SHAPE[2] // 3, dtype=torch.int8, device=dev)
    o9 = torch.empty(b, n, h * 64, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    msb = soft.stride(0) if soft.shape[0] > 1 else 0

    def calls(lib):
        def k3():
            code = lib.msvit_packed_attention_int8(q3.data_ptr(), sc3.data_ptr(), o3.data_ptr(),
                                                   1, *c.MAIN_SHAPE[:2], 12, 64, 0.125, stream)
            assert code == 0, code

        def k9():
            code = lib.msvit_packed_attention_int8_masked(
                q9.data_ptr(), sc9.data_ptr(), soft.data_ptr(), o9.data_ptr(), 1, b, n, h, 64,
                2, msb, 0, soft.stride(2), 0.125, -1e9, stream)
            assert code == 0, code

        return {"K3": k3, "K9": k9}

    with tempfile.TemporaryDirectory(prefix="int8_variants_") as tmp:
        libs = build_all(tmp)
        order = list(libs) + list(libs)[::-1]
        times = {name: {"K3": [], "K9": []} for name in libs}
        for name in order:
            for k, fn in calls(libs[name]).items():
                times[name][k].append(c.device_ms(fn, c.K39_KERNELS))
        torch.cuda.synchronize()
    res = {"card": smi, "order": order,
           **{name: {f"{k}_alone_ms": statistics.median(v) for k, v in t.items()}
              for name, t in times.items()}}
    print("VARIANTS " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
