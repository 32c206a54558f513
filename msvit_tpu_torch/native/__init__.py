"""Native (C++) host runtime, bound with ctypes (counterpart of
`msvit_tpu/native/`).

Two libraries, built with g++ on first use (nothing is built at import):

* `preprocess.cpp`: the batched bilinear resize + normalize of decoded
  uint8 images (`preprocess_batch`);
* `decode.cpp`: libjpeg decode with DCT scaling when the source is much
  larger than the target, fused with the resize (`decode_resize_u8`) or
  with resize + normalize (`decode_preprocess_batch`), or decode only
  (`decode_jpeg_batch`).

The decoder links against the system's libjpeg (``-ljpeg``, its own
headers) where the linker finds one.  Where it does not, it links against
the libjpeg-turbo that Pillow's wheel bundles (``pillow.libs/libjpeg-*.so.62*``
beside the PIL package, found from ``PIL.__file__``, with an rpath to it),
compiled against the libjpeg-turbo 2.1.5 headers kept in `native/include/`
(``JPEG_LIB_VERSION 62``, the ABI that library exports; their licence is
`include/COPYRIGHT.libjpeg-turbo`).  Where there is neither, the build
raises as below: nothing falls back to PIL silently.

The sources are copies of the JAX package's, compiled with its flags, so on
one machine both packages give the same bytes.  Each library lands in
`native/_build/` (listed in `.gitignore`) under a name that carries a hash
of its source, the flags, the libjpeg it links and the host's CPU (``-march=native`` code runs
only where it was built), so a stale library is never loaded.

Errors, as in the JAX package: no g++ raises `OSError` (FileNotFoundError);
a compile that fails (no ``jpeglib.h``, say) raises `BuildError`, a
`subprocess.CalledProcessError` whose message carries the compiler's
output.  `data.pipeline` sends a batch to PIL on `OSError` and lets a
failed build raise.

Each entry point counts its calls in a plain int attribute (``.calls``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
INCLUDE_DIR = _DIR / "include"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SZ, _U8 = ctypes.c_size_t, ctypes.c_uint8
_SIGNATURES = {
    "preprocess": {
        # srcs, dims [B, 3], batch, dst, size, mean, std
        "preprocess_batch": [ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
                             ctypes.POINTER(_F), _I, ctypes.POINTER(_F),
                             ctypes.POINTER(_F)],
    },
    "decode": {
        # blobs, lens, batch, dst, size, mean, std, ok
        "decode_preprocess_batch": [ctypes.POINTER(_P), ctypes.POINTER(_SZ), _I,
                                    ctypes.POINTER(_F), _I, ctypes.POINTER(_F),
                                    ctypes.POINTER(_F), ctypes.POINTER(_I)],
        # blobs, lens, batch, dst, size, ok
        "decode_resize_u8_batch": [ctypes.POINTER(_P), ctypes.POINTER(_SZ), _I,
                                   ctypes.POINTER(_U8), _I, ctypes.POINTER(_I)],
        # blobs, lens, batch, dst, max_h, max_w, dims, ok
        "decode_batch": [ctypes.POINTER(_P), ctypes.POINTER(_SZ), _I,
                         ctypes.POINTER(_U8), _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_I)],
    },
}
# how the decoder finds libjpeg: "system" (-ljpeg) or "pillow"
LINKS = ("system", "pillow")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class BuildError(subprocess.CalledProcessError):
    """g++ failed; the message carries its output."""

    def __str__(self) -> str:
        return f"{super().__str__()}\n{self.stderr or ''}{self.output or ''}"


def _cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("model name", "flags"))]
    return "\n".join(lines[:2])


def pillow_libjpeg() -> Optional[Path]:
    """The libjpeg that Pillow's wheel bundles (``pillow.libs/libjpeg-*.so.62*``
    beside the PIL package), or None."""
    try:
        import PIL
    except ImportError:
        return None
    found = sorted((Path(PIL.__file__).resolve().parent.parent / "pillow.libs")
                   .glob("libjpeg-*.so.62*"))
    return found[0] if found else None


@functools.lru_cache(maxsize=None)
def system_libjpeg() -> bool:
    """Whether the linker finds a libjpeg of the system's (OSError: no g++)."""
    res = subprocess.run(["g++", "-print-file-name=libjpeg.so"],
                         capture_output=True, text=True)
    return os.path.isabs(res.stdout.strip())


def link_args(name: str, link: Optional[str] = None) -> List[str]:
    """The compiler's libjpeg arguments for `name`: none for "preprocess";
    for "decode" those of `link` ("system" or "pillow"), by default the
    system's libjpeg where the linker finds one, else Pillow's, else the
    system's (whose build then fails)."""
    if name != "decode":
        return []
    if link is None:
        link = "system" if system_libjpeg() or pillow_libjpeg() is None else "pillow"
    if link not in LINKS:
        raise ValueError(f"link {link!r} is not one of {LINKS}")
    if link == "system":
        return ["-ljpeg"]
    lib = pillow_libjpeg()
    if lib is None:
        raise FileNotFoundError("Pillow bundles no libjpeg (pillow.libs/libjpeg-*.so.62*)")
    return [f"-I{INCLUDE_DIR}", str(lib), f"-Wl,-rpath,{lib.parent}"]


def library_path(name: str, link: Optional[str] = None) -> Path:
    """The library of `name` ("preprocess" or "decode") for these sources,
    flags, libjpeg (`link_args`) and CPU."""
    src = _DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(FLAGS + link_args(name, link)).encode())
    h.update(_cpu().encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libmsvit_{name}_{h.hexdigest()[:16]}.so"


def build(name: str, link: Optional[str] = None) -> Path:
    """Compile `name` unless a library of the same sources exists; returns
    its path.  The library is written under a temporary name and renamed,
    so processes that build at once never load a half-written file."""
    so = library_path(name, link)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *FLAGS, str(_DIR / f"{name}.cpp"), "-o", str(tmp),
           *link_args(name, link)]
    res = subprocess.run(cmd, capture_output=True, text=True)  # OSError: no g++
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(res.returncode, cmd, res.stdout, res.stderr)
    os.replace(tmp, so)
    return so


def load(name: str, path: Path) -> ctypes.CDLL:
    """Load a built library of `name` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    return lib


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _libs[name] = load(name, build(name))
    return _libs[name]


def _blobs(blobs: Sequence[bytes]):
    """(buffers kept alive, pointer array, length array) of encoded blobs."""
    bufs = [np.frombuffer(b, np.uint8) for b in blobs]
    ptrs = (_P * len(bufs))(*(b.ctypes.data for b in bufs))
    lens = (_SZ * len(bufs))(*(len(b) for b in bufs))
    return bufs, ctypes.cast(ptrs, ctypes.POINTER(_P)), lens


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def preprocess_batch(
    images: Sequence[np.ndarray],
    size: int,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
) -> np.ndarray:
    """[HWC uint8] x B (any per-image sizes) -> [B, size, size, 3] float32."""
    lib = _lib("preprocess")
    batch = len(images)
    contiguous = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ptrs = (_P * batch)(*(im.ctypes.data for im in contiguous))
    dims = np.empty((batch, 3), np.int32)
    for i, im in enumerate(contiguous):
        dims[i] = (*im.shape[:2], 1 if im.ndim == 2 else im.shape[2])
    out = np.empty((batch, size, size, 3), np.float32)
    mean_arr, std_arr = _f32(mean), _f32(std)
    lib.preprocess_batch(ctypes.cast(ptrs, ctypes.POINTER(_P)), _ptr(dims, _I), batch,
                         _ptr(out, _F), size, _ptr(mean_arr, _F), _ptr(std_arr, _F))
    preprocess_batch.calls += 1
    return out


preprocess_batch.calls = 0


def decode_preprocess_batch(
    blobs: Sequence[bytes],
    size: int,
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Encoded JPEG blobs -> ([B, size, size, 3] float32 normalized, ok [B]
    bool).  Decode (with DCT downscaling), bilinear resize and normalize
    run fused in C++ threads; a blob libjpeg refuses gives zeros and
    ok False."""
    lib = _lib("decode")
    bufs, ptrs, lens = _blobs(blobs)
    out = np.empty((len(bufs), size, size, 3), np.float32)
    ok = np.zeros((len(bufs),), np.int32)
    mean_arr, std_arr = _f32(mean), _f32(std)
    lib.decode_preprocess_batch(ptrs, lens, len(bufs), _ptr(out, _F), size,
                                _ptr(mean_arr, _F), _ptr(std_arr, _F), _ptr(ok, _I))
    decode_preprocess_batch.calls += 1
    return out, ok.astype(bool)


decode_preprocess_batch.calls = 0


def decode_resize_u8(blobs: Sequence[bytes], size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Encoded JPEG blobs -> ([B, size, size, 3] uint8, ok [B] bool): decode
    (DCT downscaling) + bilinear resize, no normalization (the uint8 wire;
    normalize on the device with `data.pipeline.preprocess_on_device`)."""
    lib = _lib("decode")
    bufs, ptrs, lens = _blobs(blobs)
    out = np.empty((len(bufs), size, size, 3), np.uint8)
    ok = np.zeros((len(bufs),), np.int32)
    lib.decode_resize_u8_batch(ptrs, lens, len(bufs), _ptr(out, _U8), size, _ptr(ok, _I))
    decode_resize_u8.calls += 1
    return out, ok.astype(bool)


decode_resize_u8.calls = 0


def decode_jpeg_batch(
    blobs: Sequence[bytes], max_h: int, max_w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encoded JPEG blobs -> (packed [B, max_h, max_w, 3] uint8, dims [B, 2]
    actual (h, w), ok [B] bool)."""
    lib = _lib("decode")
    bufs, ptrs, lens = _blobs(blobs)
    out = np.zeros((len(bufs), max_h, max_w, 3), np.uint8)
    dims = np.zeros((len(bufs), 2), np.int32)
    ok = np.zeros((len(bufs),), np.int32)
    lib.decode_batch(ptrs, lens, len(bufs), _ptr(out, _U8), max_h, max_w,
                     _ptr(dims, _I), _ptr(ok, _I))
    decode_jpeg_batch.calls += 1
    return out, dims, ok.astype(bool)


decode_jpeg_batch.calls = 0
