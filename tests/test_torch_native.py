"""The port's native host runtime (`msvit_tpu_torch/native`, the C++
preprocessor and libjpeg decoder) and the decoders of its image pipeline
against the JAX package's, on the CPU: the same sources and flags give the
same bytes.  Also the fallback ladder (no g++ -> PIL for the batch; a blob
libjpeg refuses -> PIL alone; unreadable -> zeros; a failed compile
raises) and the route counters.

Sources at 500 x 375 and 900 x 675 take libjpeg's DCT scaling at 112 px:
there the PIL route (the port's only route before it had a native decoder)
differs from the native one by many uint8 levels.
"""

import io

import numpy as np
import pytest
from PIL import Image

from msvit_tpu import native as jnative
from msvit_tpu.data import pipeline as jpipe
from msvit_tpu_torch import native
from msvit_tpu_torch.data import pipeline as tpipe

SIZE = 112
SOURCES = [(120, 160), (375, 500), (675, 900)]  # (h, w)


def _jpeg(h: int, w: int, seed: int, gray: bool = False) -> bytes:
    """A q95 JPEG of a smooth random image (upsampled noise, so the DCT
    has real content at every scale)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _blobs():
    blobs = [_jpeg(h, w, i) for i, (h, w) in enumerate(SOURCES)]
    blobs.append(_jpeg(200, 300, 7, gray=True))
    blobs.append(b"not a jpeg at all")
    return blobs


def _configs(size=SIZE):
    return tpipe.ImagePipelineConfig(image_size=size), jpipe.ImagePipelineConfig(image_size=size)


def test_preprocess_batch_equals_jax():
    """`native.preprocess_batch` against the JAX package's, byte for byte:
    RGB at several sizes (up and down), grayscale, a non-contiguous view."""
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (40, 30, 4), dtype=np.uint8)
    images = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
              rng.integers(0, 256, (16, 16), dtype=np.uint8),
              rng.integers(0, 256, (300, 200, 3), dtype=np.uint8),
              rgba[..., :3]]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = native.preprocess_batch(images, 32, mean, std)
    want = jnative.preprocess_batch(images, 32, mean, std)
    assert got.dtype == np.float32 and got.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    cfg_t, cfg_j = _configs(32)
    np.testing.assert_array_equal(tpipe.preprocess_images(images, cfg_t),
                                  jpipe.preprocess_images(images, cfg_j))


@pytest.mark.parametrize("route", ["u8", "f32"])
def test_pipeline_decoders_equal_jax(route):
    """`decode_jpeg_images_u8` and `decode_jpeg_images` against the JAX
    package's, byte for byte, at 160 x 120, 500 x 375 and 900 x 675 ->
    112 px, a grayscale JPEG and a corrupt blob (zeros on both)."""
    blobs = _blobs()
    cfg_t, cfg_j = _configs()
    if route == "u8":
        got, want = tpipe.decode_jpeg_images_u8(blobs, cfg_t), jpipe.decode_jpeg_images_u8(blobs, cfg_j)
        assert got.dtype == np.uint8
    else:
        got, want = tpipe.decode_jpeg_images(blobs, cfg_t), jpipe.decode_jpeg_images(blobs, cfg_j)
        assert got.dtype == np.float32
    assert got.shape == (len(blobs), SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()  # the corrupt blob


def test_native_entry_points_equal_jax():
    """The three decode entry points of `native` against the JAX package's:
    the fused u8 and f32 decodes (with their ok flags) and the decode-only
    batch (dims, ok)."""
    blobs = _blobs()
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    for a, b in zip(native.decode_resize_u8(blobs, 64), jnative.decode_resize_u8(blobs, 64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(native.decode_preprocess_batch(blobs, 64, mean, std),
                    jnative.decode_preprocess_batch(blobs, 64, mean, std)):
        np.testing.assert_array_equal(a, b)
    got = native.decode_jpeg_batch(blobs, 700, 900)
    for a, b in zip(got, jnative.decode_jpeg_batch(blobs, 700, 900)):
        np.testing.assert_array_equal(a, b)
    assert got[2].tolist() == [True, True, True, True, False]
    assert got[1][:3].tolist() == [[h, w] for h, w in SOURCES]


def _no_native(monkeypatch):
    """Make the native libraries unloadable, as without g++ (OSError)."""
    def unavailable(name):
        raise OSError("no toolchain")

    monkeypatch.setattr(native, "_lib", unavailable)


def test_pil_route_differs_where_the_dct_scales(monkeypatch):
    """The whole batch goes to PIL when the native module raises OSError;
    that route matches the native one at 160 x 120 (within a level) but not
    at 500 x 375 and 900 x 675, where libjpeg decodes at a DCT scale of 1/2
    or 1/4 (the difference the native port repairs); it stays within the
    JAX package's bar against PIL (mean abs < 0.05 normalized)."""
    blobs = _blobs()[:3]
    cfg_t, _ = _configs()
    nat = tpipe.decode_jpeg_images_u8(blobs, cfg_t).astype(np.int16)
    nat_f32 = tpipe.decode_jpeg_images(blobs, cfg_t)
    _no_native(monkeypatch)
    before = tpipe.decode_jpeg_images_u8.pil_images
    pil = tpipe.decode_jpeg_images_u8(blobs, cfg_t).astype(np.int16)
    assert tpipe.decode_jpeg_images_u8.pil_images - before == 3
    diff = np.abs(nat - pil).reshape(3, -1).max(1)
    assert diff[0] <= 1 and diff[1] > 2 and diff[2] > 2, diff
    pil_f32 = tpipe.decode_jpeg_images(blobs, cfg_t)
    assert float(np.abs(nat_f32 - pil_f32).mean()) < 0.05


def test_route_counters():
    """Each native entry point counts its calls; a blob libjpeg refuses
    and PIL cannot read counts as unreadable, not as a PIL image."""
    blobs = _blobs()
    cfg_t, _ = _configs(32)
    calls = (native.decode_resize_u8.calls, native.decode_preprocess_batch.calls,
             native.preprocess_batch.calls)
    counts = (tpipe.decode_jpeg_images_u8.pil_images, tpipe.decode_jpeg_images_u8.unreadable,
              tpipe.decode_jpeg_images.unreadable)
    tpipe.decode_jpeg_images_u8(blobs, cfg_t)
    tpipe.decode_jpeg_images(blobs, cfg_t)
    tpipe.preprocess_images([np.zeros((8, 8, 3), np.uint8)], cfg_t)
    assert (native.decode_resize_u8.calls - calls[0], native.decode_preprocess_batch.calls
            - calls[1], native.preprocess_batch.calls - calls[2]) == (1, 1, 1)
    assert (tpipe.decode_jpeg_images_u8.pil_images - counts[0],
            tpipe.decode_jpeg_images_u8.unreadable - counts[1],
            tpipe.decode_jpeg_images.unreadable - counts[2]) == (0, 1, 1)


def test_refused_blob_goes_to_pil_alone(monkeypatch):
    """A blob the native decoder reports as not ok is decoded by PIL, the
    others keep the native bytes (a PNG stands for a blob libjpeg refuses
    and PIL reads)."""
    png = io.BytesIO()
    Image.fromarray(np.full((10, 12, 3), 200, np.uint8)).save(png, format="PNG")
    blobs = [_jpeg(120, 160, 0), png.getvalue()]
    cfg_t, cfg_j = _configs(32)
    before = tpipe.decode_jpeg_images_u8.pil_images
    got = tpipe.decode_jpeg_images_u8(blobs, cfg_t)
    assert tpipe.decode_jpeg_images_u8.pil_images - before == 1
    np.testing.assert_array_equal(got, jpipe.decode_jpeg_images_u8(blobs, cfg_j))
    assert (got[1] == 200).all()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile raises `BuildError` (a
    CalledProcessError, which the pipeline does not catch) carrying g++'s
    message; no g++ on the PATH raises OSError, which sends the batch to
    PIL."""
    import subprocess

    (tmp_path / "decode.cpp").write_text('#include "no_such_header.h"\n')
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(subprocess.CalledProcessError, match="no_such_header"):
        native.build("decode")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(subprocess.CalledProcessError):
        tpipe.decode_jpeg_images_u8([_jpeg(120, 160, 0)], _configs(32)[0])
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(OSError):
        native.build("decode")
    before = tpipe.decode_jpeg_images_u8.pil_images
    out = tpipe.decode_jpeg_images_u8([_jpeg(120, 160, 0)], _configs(32)[0])
    assert tpipe.decode_jpeg_images_u8.pil_images - before == 1 and out.any()


def test_library_name_follows_source_and_flags(monkeypatch):
    """A library is named by a hash of its source, flags and CPU, so a
    changed source is rebuilt, never loaded stale."""
    a = native.library_path("decode")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-DMSVIT_PROBE"])
    b = native.library_path("decode")
    assert a != b and a.parent == b.parent == native.BUILD_DIR
    assert a.name.startswith("libmsvit_decode_")


@pytest.mark.parametrize("system,pillow,want", [
    (True, True, "system"), (False, True, "pillow"), (False, False, "system")])
def test_libjpeg_link_choice(monkeypatch, system, pillow, want):
    """The decoder links the system's libjpeg where the linker finds one,
    else the one Pillow's wheel bundles (vendored libjpeg-turbo 62 headers,
    an rpath to the library), else the system's again, whose build then
    raises `BuildError`: nothing falls back to PIL silently.  The choice
    enters the library's name."""
    lib = native.pillow_libjpeg()
    monkeypatch.setattr(native, "system_libjpeg", lambda: system)
    monkeypatch.setattr(native, "pillow_libjpeg", lambda: lib if pillow else None)
    args = native.link_args("decode")
    if want == "system":
        assert args == ["-ljpeg"]
    else:
        assert args[0] == f"-I{native.INCLUDE_DIR}" and args[1] == str(lib)
        assert args[2] == f"-Wl,-rpath,{lib.parent}"
        assert native.library_path("decode") != native.library_path("decode", "system")
    assert native.link_args("preprocess") == []


def test_pillow_linked_decoder_equals_system_and_jax():
    """The decoder linked against Pillow's bundled libjpeg-turbo gives the
    bytes of the one linked against the system's libjpeg and of the JAX
    package's, at 160 x 120, 500 x 375 and 900 x 675 -> 112 px (the last two
    through libjpeg's scaled DCT), in all three entry points."""
    if native.pillow_libjpeg() is None:
        pytest.skip("this Pillow bundles no libjpeg")
    blobs = _blobs()
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    got = {}
    for link in native.LINKS:
        native._libs["decode"] = native.load("decode", native.build("decode", link))
        try:
            got[link] = (native.decode_resize_u8(blobs, SIZE),
                         native.decode_preprocess_batch(blobs, SIZE, mean, std),
                         native.decode_jpeg_batch(blobs, 700, 900))
        finally:
            native._libs.pop("decode")
    want = (jnative.decode_resize_u8(blobs, SIZE),
            jnative.decode_preprocess_batch(blobs, SIZE, mean, std),
            jnative.decode_jpeg_batch(blobs, 700, 900))
    for entry in range(3):
        for a, b, c in zip(got["pillow"][entry], got["system"][entry], want[entry]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
