"""Build and load the port's hand-written CUDA kernels.

Every `msvit_tpu_torch/csrc/*.cu` is compiled by `nvcc` for Hopper
(`sm_90a`), one `nvcc` per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, loaded with
`ctypes`.  Nothing is built at import: the first kernel launch calls
`library()`, which builds into `msvit_tpu_torch/_build/` (listed in
`.gitignore`).  The library's file name carries a hash of the sources and
the flags, so a stale library is never loaded.  A failed build raises.
ptxas's report (registers, shared memory, spills per kernel) is kept
beside the library (`ptxas_report()`).

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer).
_SIGNATURES = {
    # qkv, mask, out, dtype, b, n, h, dh, mask_kind, mask_sb, mask_sh,
    # scale, mask_value, stream
    "msvit_packed_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL,
                               _F, _F, _P],
    # qkv_q, scales[4], out, int8_out, b, n, h, dh, scale, stream
    "msvit_packed_attention_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # qkv, mask, out, lse, dtype, b, n, h, dh, mask_kind, mask_sb, mask_sh,
    # scale, mask_value, stream
    "msvit_packed_attention_lse": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _LL, _LL, _F, _F, _P],
    # qkv, mask, out, lse, g, delta, dqkv, dtype, b, n, h, dh, mask_kind,
    # mask_sb, mask_sh, scale, mask_value, stream
    "msvit_packed_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _LL, _LL, _F, _F, _P],
    # q, k, v, mask, out, dtype, b, h, nq, nk, dh, strides[12] (host),
    # mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value, stream
    "msvit_fused_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(_LL), _I, _LL, _LL, _LL, _F, _F, _P],
    "msvit_fused_attention_inference": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, ctypes.POINTER(_LL), _I, _LL,
                                        _LL, _LL, _F, _F, _P],
    # q, k, v, mask, out, lse, then as msvit_fused_attention
    "msvit_fused_attention_lse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, ctypes.POINTER(_LL), _I, _LL, _LL, _LL, _F,
                                  _F, _P],
    # dh, mask_kind, shaved, blocks (out): K4's or K5's blocks per SM
    "msvit_fused_attention_occupancy": [_I, _I, _I, ctypes.POINTER(_I)],
    # K7 and K7-lse: as msvit_fused_attention and msvit_fused_attention_lse
    "msvit_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(_LL), _I, _LL, _LL, _LL, _F, _F, _P],
    "msvit_flash_attention_lse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, ctypes.POINTER(_LL), _I, _LL, _LL, _LL, _F,
                                  _F, _P],
    # qkv, cid, band, out, dtype, b, n, pfx, h, dh, image stride, row
    # stride, stream
    "msvit_banded_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL,
                               _LL, _P],
    # qkv_q, scales[4], mask, out, int8_out, b, n, h, dh, mask_kind, mask_sb,
    # mask_sh, mask_sr, scale, mask_value, stream
    "msvit_packed_attention_int8_masked": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _LL, _LL, _LL, _F, _F, _P],
    # wgmma, dh, blocks (out): K1-lse's bf16 blocks per SM
    "msvit_packed_attention_lse_occupancy": [_I, _I, ctypes.POINTER(_I)],
    # wgmma, which (0 dQ, 1 dK/dV), dh, blocks (out): K2's bf16 blocks per SM
    "msvit_packed_attention_bwd_occupancy": [_I, _I, _I, ctypes.POINTER(_I)],
    # dh, masked, mask_kind, blocks (out): K3's or K9's blocks per SM
    "msvit_packed_attention_int8_occupancy": [_I, _I, _I, ctypes.POINTER(_I)],
    # q, k, v, out, g, lse, mask, delta, dq, dk, dv, dtype, b, h, nq, nk, dh,
    # strides[24] (host), mask_kind, mask_sb, mask_sh, mask_sr, scale, mask_value,
    # stream
    "msvit_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, ctypes.POINTER(_LL),
                                  _I, _LL, _LL, _LL, _F, _F, _P],
}

_lock = threading.Lock()
_lib = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def _library_path() -> Path:
    return BUILD_DIR / f"libmsvit_kernels_{source_hash()}.so"


def ptxas_report() -> Path:
    """ptxas's per-kernel report of the current library's build."""
    return _library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{cu.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj), str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    report, failed = [], []
    for cmd, _, proc in jobs:  # wait for every compile, failed or not
        text = proc.communicate()[0]
        report.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(report[-1])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    tmp = so.with_name(f"{tag}.tmp.so")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
           *(str(obj) for _, obj, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(
            f"kernel link failed ({' '.join(cmd)}):\n{res.stdout}\n{res.stderr}"
        )
    ptxas_report().write_text("\n".join(report))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.msvit_error_string.argtypes = [ctypes.c_int]
            lib.msvit_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.msvit_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
