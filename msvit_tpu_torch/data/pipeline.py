"""Image pipeline (counterpart of `msvit_tpu/data/pipeline.py`): decode,
resize, normalize, grayscale to 3 channels, and the host-to-device feed.

* `preprocess_images`: host path (numpy / PIL) for arbitrary inputs,
  [B, S, S, 3] float32, normalized.
* `preprocess_on_device`: device path for already-decoded uint8 tensors:
  resize, rescale and normalize on the device the tensor lies on.
* `decode_jpeg_images_u8`: encoded JPEG bytes to [B, S, S, 3] uint8 through
  PIL (the JAX package's ctypes C++ decoder is not ported).
* `prefetch_to_device`: a worker thread runs the host iterator, stages each
  batch in pinned host memory and copies it on a side stream, so the host
  prepares batch i+1.. while the device computes on batch i.  uint8 on the
  wire and the normalization on the device move a quarter of the bytes of
  an f32 feed.

Not ported: `load_image_batches` (a hub dataset loader; it needs a
download) and the f32 `decode_jpeg_images`.
"""

from __future__ import annotations

import dataclasses
import io
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
    """Host path -> [B, S, S, 3] float32, normalized (the JAX package's
    numpy path: half-pixel bilinear resize, x / 255, mean / std)."""
    s = config.image_size
    out = np.empty((len(images), s, s, 3), np.float32)
    mean = np.asarray(config.mean, np.float32)
    std = np.asarray(config.std, np.float32)
    for i, im in enumerate(images):
        resized = _resize_bilinear_np(to_rgb_array(im).astype(np.float32), s, s)
        out[i] = (resized / 255.0 - mean) / std
    return out


def preprocess_on_device(
    images_u8: torch.Tensor,  # [B, H, W, 3] uint8
    config: ImagePipelineConfig = ImagePipelineConfig(),
) -> torch.Tensor:
    """Device path: resize + rescale + normalize where the tensor lies.
    The resize is half-pixel bilinear, antialiased when it shrinks (as
    `jax.image.resize`)."""
    s = config.image_size
    x = images_u8.float()
    if x.shape[1] != s or x.shape[2] != s:
        if config.method != "bilinear":
            raise NotImplementedError(f"resize method {config.method!r}")
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True).permute(0, 2, 3, 1)
    mean = torch.tensor(config.mean, device=x.device)
    std = torch.tensor(config.std, device=x.device)
    return (x / 255.0 - mean) / std


def decode_jpeg_images_u8(
    blobs: Sequence[bytes],
    config: ImagePipelineConfig = ImagePipelineConfig(),
) -> np.ndarray:
    """Encoded JPEG bytes -> [B, S, S, 3] **uint8** (decoded and resized,
    NOT normalized): the wire format of the host-to-device feed, with
    `preprocess_on_device` (or ``/ 127.5 - 1``) on the device.  Decodes
    with PIL; an image PIL cannot read comes out black, as in the JAX
    package."""
    from PIL import Image, UnidentifiedImageError

    s = config.image_size
    out = np.zeros((len(blobs), s, s, 3), np.uint8)
    for i, blob in enumerate(blobs):
        try:
            img = Image.open(io.BytesIO(blob)).convert("RGB")
        except (UnidentifiedImageError, OSError):
            continue  # keep zeros
        arr = to_rgb_array(img)
        if arr.shape[:2] != (s, s):
            arr = np.clip(_resize_bilinear_np(arr.astype(np.float32), s, s) + 0.5, 0, 255)
        out[i] = arr.astype(np.uint8)
    return out


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
