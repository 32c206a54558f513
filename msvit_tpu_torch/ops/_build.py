"""Build and load the port's hand-written CUDA kernels.

Every `msvit_tpu_torch/csrc/*.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into ONE shared library with a plain C interface, loaded with
`ctypes`.  Nothing is built at import: the first kernel launch calls
`library()`, which builds into `msvit_tpu_torch/_build/` (listed in
`.gitignore`).  The library's file name carries a hash of the sources and
the flags, so a stale library is never loaded.  A failed build raises.

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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

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


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path."""
    so = BUILD_DIR / f"libmsvit_kernels_{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{res.stdout}\n{res.stderr}"
        )
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
