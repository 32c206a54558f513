"""Image pipeline (counterpart of `msvit_tpu/data/pipeline.py`): decode,
resize, normalize, grayscale to 3 channels, and the host-to-device feed.

* `preprocess_images`: host path for arbitrary inputs, [B, S, S, 3]
  float32, normalized: the native C++ preprocessor (`msvit_tpu_torch.native`),
  or numpy where it cannot be built.
* `preprocess_on_device`: device path for already-decoded uint8 tensors:
  resize, rescale and normalize on the device the tensor lies on.  The
  resize is `jax.image.resize`'s (`resize_like_jax`): every method it
  takes, one weight matrix per axis (its kernels, antialiased when the
  axis shrinks), in plain torch.
* `decode_jpeg_images` / `decode_jpeg_images_u8`: encoded JPEG bytes to
  [B, S, S, 3] float32 (normalized) or uint8 (resized only) through the
  native libjpeg decoder, which scales in the DCT domain when the source
  is much larger than the target: the same bytes as the JAX package's.
* `prefetch_to_device`: a worker thread runs the host iterator, stages each
  batch in pinned host memory and copies it on a side stream, so the host
  prepares batch i+1.. while the device computes on batch i.  uint8 on the
  wire and the normalization on the device move a quarter of the bytes of
  an f32 feed.
* `load_image_batches`: a `datasets` dataset (a local image folder, say)
  decoded natively and fed through `prefetch_to_device`.

The JAX package's fallback ladder, exactly: an `ImportError` or `OSError`
from the native module (no g++) sends the whole batch to PIL; a blob that
libjpeg refuses goes to PIL alone; an image neither can read gives zeros
(f32) or black (uint8).  A decoder that fails to compile (no
``jpeglib.h``) raises.  Counters show the route that ran: the native entry
points' ``.calls``, and each decoder's ``.pil_images`` (images decoded by
PIL) and ``.unreadable`` (images left zero).
"""

from __future__ import annotations

import dataclasses
import io
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImagePipelineConfig:
    image_size: int = 224
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    method: str = "bilinear"  # resize filter


def to_rgb_array(image: Any) -> np.ndarray:
    """PIL image / ndarray -> HWC uint8/float RGB; grayscale is tiled to 3
    channels, an alpha channel is dropped."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.tile(arr[..., None], (1, 1, 3))
    if arr.shape[-1] == 1:
        arr = np.tile(arr, (1, 1, 3))
    if arr.shape[-1] == 4:  # drop alpha
        arr = arr[..., :3]
    return arr


def _resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Half-pixel-centered bilinear resize."""
    ih, iw = img.shape[:2]
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    ty = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    tx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0[:, None], x0[None, :]]
    b = img[y0[:, None], x1[None, :]]
    c = img[y1[:, None], x0[None, :]]
    d = img[y1[:, None], x1[None, :]]
    top = a * (1 - tx) + b * tx
    bot = c * (1 - tx) + d * tx
    return top * (1 - ty) + bot * ty


def preprocess_images(
    images: Sequence[Any], config: ImagePipelineConfig = ImagePipelineConfig()
) -> np.ndarray:
    """Host path -> [B, S, S, 3] float32, normalized: the native C++
    preprocessor, or, where it cannot be built, numpy (half-pixel bilinear
    resize, x / 255, mean / std)."""
    s = config.image_size
    arrays = [to_rgb_array(im) for im in images]
    try:
        from msvit_tpu_torch.native import preprocess_batch

        return preprocess_batch(arrays, s, config.mean, config.std)
    except (ImportError, OSError):
        pass

    out = np.empty((len(arrays), s, s, 3), np.float32)
    mean = np.asarray(config.mean, np.float32)
    std = np.asarray(config.std, np.float32)
    for i, arr in enumerate(arrays):
        resized = _resize_bilinear_np(arr.astype(np.float32), s, s)
        out[i] = (resized / 255.0 - mean) / std
    return out


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (`F.interpolate`'s
    bicubic takes -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi**2 * x**2, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


_RESIZE_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def resize_weights(m: int, n: int, method: str, device=None) -> torch.Tensor:
    """[m, n] f32: the weights that take an axis of m samples to n, as
    `jax.image.resize` computes them (`compute_weight_mat`, antialias on):
    output j samples input position (j + 0.5) m / n - 0.5 through the
    method's kernel, widened by m / n when the axis shrinks; each column
    normalized to sum 1; a sample outside the input weighs nothing."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"Unknown resize method {method!r}")
    inv_scale = 1.0 / (n / m)
    kernel_scale = float(np.float32(max(inv_scale, 1.0)))
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(m, dtype=torch.float32, device=device)
    w = _RESIZE_KERNELS[method]((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_like_jax(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """`jax.image.resize(x, (B, H', W', C), method)` of an f32 [B, H, W, C]
    tensor: "nearest" picks input floor((j + 0.5) m / n) along each axis;
    every other method contracts each axis whose size changes with its
    `resize_weights` (H first, then W; JAX contracts both in one einsum, so
    sums can round apart)."""
    for axis, n in ((1, size[0]), (2, size[1])):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m
                   / n).floor().long()
            x = x.index_select(axis, idx)
        elif axis == 1:
            x = torch.einsum("bhwc,hy->bywc", x, resize_weights(m, n, method, x.device))
        else:
            x = torch.einsum("bhwc,wy->bhyc", x, resize_weights(m, n, method, x.device))
    return x


def preprocess_on_device(
    images_u8: torch.Tensor,  # [B, H, W, 3] uint8
    config: ImagePipelineConfig = ImagePipelineConfig(),
) -> torch.Tensor:
    """Device path: resize + rescale + normalize where the tensor lies.
    The resize is `jax.image.resize` with `config.method` (`resize_like_jax`:
    "nearest", "linear"/"bilinear", "cubic"/"bicubic", "lanczos3",
    "lanczos5"), antialiased when it shrinks."""
    s = config.image_size
    x = images_u8.float()
    if x.shape[1] != s or x.shape[2] != s:
        x = resize_like_jax(x, (s, s), config.method)
    mean = torch.tensor(config.mean, device=x.device)
    std = torch.tensor(config.std, device=x.device)
    return (x / 255.0 - mean) / std


def _native_or_pil(native, blobs: Sequence[bytes], out: np.ndarray, pil_one, counter) -> np.ndarray:
    """The fallback ladder: `native(blobs)` -> (out, ok); an `ImportError`
    or `OSError` from the native module sends every blob to PIL, and each
    blob that it refused goes to `pil_one(image) -> row` alone; a blob PIL
    cannot read either keeps `out`'s zeros."""
    try:
        out, ok = native(blobs)
    except (ImportError, OSError):
        ok = np.zeros((len(blobs),), bool)
    if not ok.all():
        from PIL import Image

        for i in np.nonzero(~ok)[0]:
            try:
                out[i] = pil_one(Image.open(io.BytesIO(blobs[i])))
            except Exception:  # any unreadable blob keeps its zeros
                counter.unreadable += 1
                continue
            counter.pil_images += 1
    return out


def decode_jpeg_images(
    blobs: Sequence[bytes],
    config: ImagePipelineConfig = ImagePipelineConfig(),
) -> np.ndarray:
    """Encoded JPEG bytes -> normalized [B, S, S, 3] float32 through the
    native fused decode + resize + normalize (`native/decode.cpp`; DCT
    downscaling, threaded across the batch); the fallback ladder of the
    module's docstring, an unreadable image giving zeros."""
    s = config.image_size

    def native(b):
        from msvit_tpu_torch.native import decode_preprocess_batch

        return decode_preprocess_batch(b, s, config.mean, config.std)

    return _native_or_pil(native, blobs, np.zeros((len(blobs), s, s, 3), np.float32),
                          lambda img: preprocess_images([img], config)[0],
                          decode_jpeg_images)


decode_jpeg_images.pil_images = 0
decode_jpeg_images.unreadable = 0


def decode_jpeg_images_u8(
    blobs: Sequence[bytes],
    config: ImagePipelineConfig = ImagePipelineConfig(),
) -> np.ndarray:
    """Encoded JPEG bytes -> [B, S, S, 3] **uint8** (decoded and resized,
    NOT normalized): the wire format of the host-to-device feed, with
    `preprocess_on_device` (or ``/ 127.5 - 1``) on the device.  The native
    decoder (DCT downscaling) and the fallback ladder of the module's
    docstring; an unreadable image comes out black (u8 zeros, -mean/std
    after the device normalization), where the f32 path gives zeros in
    normalized space."""
    s = config.image_size

    def native(b):
        from msvit_tpu_torch.native import decode_resize_u8

        return decode_resize_u8(b, s)

    def pil_one(img):
        arr = to_rgb_array(img.convert("RGB")).astype(np.float32)
        return np.clip(_resize_bilinear_np(arr, s, s) + 0.5, 0, 255).astype(np.uint8)

    return _native_or_pil(native, blobs, np.zeros((len(blobs), s, s, 3), np.uint8),
                          pil_one, decode_jpeg_images_u8)


decode_jpeg_images_u8.pil_images = 0
decode_jpeg_images_u8.unreadable = 0


class _PinnedRing:
    """`slots` sets of pinned host buffers, one per batch key, reused in
    turn.  A slot is refilled only after the copy that last read it has
    completed (its event)."""

    def __init__(self, slots: int):
        self.buffers = [{} for _ in range(slots)]
        self.events: list = [None] * slots
        self.turn = 0

    def stage(self, item: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        slot = self.turn
        self.turn = (self.turn + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        bufs, out = self.buffers[slot], {}
        for k, v in item.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            if not isinstance(v, torch.Tensor) or v.device.type != "cpu":
                out[k] = v
                continue
            buf = bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = bufs[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v)
            out[k] = buf
        return slot, out


def prefetch_to_device(
    iterator: Iterator[dict],
    buffer_size: int = 2,
    device=None,
    transform: Optional[Callable[[dict], dict]] = None,
) -> Iterator[dict]:
    """Host-to-device prefetch, `buffer_size` batches deep: a background
    thread runs the (decode / preprocess) iterator and sends each batch to
    `device` ahead of the consumer.  numpy arrays and CPU tensors of a
    batch dict are sent; other values pass through.

    `device` defaults to the CUDA card (it raises without one); there the
    worker stages each batch in pinned host memory (a ring of buffers,
    reused) and copies it on a side stream with `non_blocking=True`, and the
    consumer's current stream waits on the copy's event before the batch is
    handed out: the consumer's host thread never waits for the device (the
    worker does, only to reuse a ring slot whose copy is still in flight).
    On the CPU the batch is only converted to tensors.

    ``transform`` (optional) maps the device dict to its final form inside
    the worker, on the side stream: e.g. `preprocess_on_device` turning
    wire-format uint8 pixels into normalized f32.

    Closing the generator (or dropping it) stops the worker; an exception
    in the iterator or the transform is re-raised in the consumer."""
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("prefetch_to_device: no CUDA device (pass device='cpu')")
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put, so the worker notices when the consumer has gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            # queued + the one being handed out + the one being filled
            ring = _PinnedRing(buffer_size + 2) if on_card else None
            side = torch.cuda.Stream(dev) if on_card else None
            with torch.no_grad():
                for item in iterator:
                    if stop.is_set():
                        return
                    event = None
                    if on_card:
                        slot, staged = ring.stage(item)
                        with torch.cuda.stream(side):
                            item = {k: (v.to(dev, non_blocking=True)
                                        if isinstance(v, torch.Tensor) else v)
                                    for k, v in staged.items()}
                            copied = torch.cuda.Event()
                            copied.record(side)
                            ring.events[slot] = copied
                            if transform is not None:
                                item = transform(item)
                            event = torch.cuda.Event()
                            event.record(side)
                    else:
                        item = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                for k, v in item.items()}
                        if transform is not None:
                            item = transform(item)
                    if not _put((item, event)):
                        return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="prefetch_to_device")
    t.start()
    try:
        while True:
            got = q.get()
            if got is sentinel:
                if err:
                    raise err[0]
                return
            item, event = got
            if event is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(event)
                for v in item.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        v.record_stream(cur)  # allocated on the side stream
            yield item
    finally:
        stop.set()
        try:  # drain, so a worker blocked in a put sees the stop
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)


def _read_blob(image: Any) -> bytes:
    """An image column's value under ``datasets.Image(decode=False)``:
    {"bytes": ..., "path": ...}; file-backed datasets (an image folder)
    give bytes None and a path, read here."""
    blob = image.get("bytes")
    if blob is None and image.get("path"):
        with open(image["path"], "rb") as f:
            blob = f.read()
    return blob if blob is not None else b""


def load_image_batches(
    dataset_id: str,
    split: str = "train",
    batch_size: int = 32,
    config: ImagePipelineConfig = ImagePipelineConfig(),
    streaming: bool = True,
    image_key: str = "image",
    label_key: Optional[str] = "label",
    shuffle_seed: Optional[int] = None,
    prefetch: int = 2,
    native_decode: bool = True,
    wire_dtype: str = "uint8",
    device=None,
) -> Iterator[dict]:
    """A `datasets` loader: yields {"pixel_values": [B, S, S, 3] f32,
    "labels": [B] int or None}, full batches only.  `dataset_id` is what
    `datasets.load_dataset` takes: a local directory is read as an image
    folder (class sub-folders give the labels); nothing is downloaded
    unless the id names a hub dataset and the network allows it.

    With `native_decode` the image column is read as encoded bytes and
    decoded by the native JPEG decoder; with ``prefetch > 0`` batches are
    prepared and sent to `device` (default: the CUDA card) by
    `prefetch_to_device`'s worker thread.  ``wire_dtype="uint8"`` (the
    default, with native decode and prefetch) sends the resized uint8 (a
    quarter of the bytes) and normalizes on the device
    (`preprocess_on_device`); ``"float32"`` normalizes on the host.  With
    ``prefetch=0`` the batches stay numpy on the host."""
    try:
        import datasets  # noqa: PLC0415
    except ImportError as e:
        raise ImportError("`datasets` is required for load_image_batches") from e

    ds = datasets.load_dataset(dataset_id, split=split, streaming=streaming)
    if native_decode:
        try:
            ds = ds.cast_column(image_key, datasets.Image(decode=False))
        except Exception:  # a column that is not an image: decode in Python
            native_decode = False
    if shuffle_seed is not None:
        ds = ds.shuffle(seed=shuffle_seed)

    u8_wire = wire_dtype == "uint8" and native_decode and prefetch > 0

    def gen() -> Iterator[dict]:
        images, labels = [], []
        for row in ds:
            images.append(row[image_key])
            if label_key is not None and label_key in row:
                labels.append(row[label_key])
            if len(images) == batch_size:
                if native_decode:
                    blobs = [_read_blob(im) for im in images]
                    decode = decode_jpeg_images_u8 if u8_wire else decode_jpeg_images
                    pix = decode(blobs, config)
                else:
                    pix = preprocess_images(images, config)
                yield {"pixel_values": pix,
                       "labels": np.asarray(labels) if labels else None}
                images, labels = [], []

    it = gen()
    if prefetch <= 0:
        return it
    transform = None
    if u8_wire:
        def transform(item):
            return {**item, "pixel_values": preprocess_on_device(item["pixel_values"], config)}

    return prefetch_to_device(it, buffer_size=prefetch, device=device, transform=transform)
